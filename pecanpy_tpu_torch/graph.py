"""Host-side graph containers and I/O.

Copied from ``pecanpy_tpu/graph.py``: that package cannot be imported
without jax. Only the pure-Python edgelist parser came along; the native
C++ parser (``read_edg(engine="native")``) is not ported yet and raises.

This layer is deliberately plain numpy/Python: it parses edge lists, builds
CSR / dense adjacency containers, and manages the node-ID registry. Device
layouts for the walk engine are built from these containers by
``pecanpy_tpu_torch.ops.layout``.

Behavioral contracts mirrored from the reference (``src/pecanpy/graph.py``):

* ``.edg`` parsing: 2 or 3 columns, configurable delimiter (default tab),
  weighted files must have exactly 3 columns (``graph.py:160-179``).
* Non-positive edge weights are dropped with a ``RuntimeWarning``
  (``graph.py:181-192``).
* Re-specifying an edge with a different weight warns and keeps the last
  weight (``graph.py:194-215``).
* Undirected graphs insert both edge directions (``graph.py:243-268``).
* CSR rows list neighbors in ascending order (``graph.py:323-341``) — the
  walk kernels rely on this sorted invariant.
* ``.csr.npz`` files hold keys ``IDs``/``data``/``indptr``/``indices``;
  ``.dense.npz`` files hold ``IDs``/``data`` (``graph.py:488-496,627-629``).
* Missing ``IDs`` in an npz triggers implicit canonical string IDs with a
  warning unless ``implicit_ids=True`` (``graph.py:55-97``).
"""
import warnings

import numpy as np

from pecanpy_tpu_torch.typing import (
    AdjMat,
    CSR,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

IMPLICIT_IDS_WARNING = (
    "WARNING: Implicitly set node IDs to the canonical node ordering due to "
    "missing IDs field in the raw CSR npz file. This warning message can be "
    "suppressed by setting implicit_ids to True in the read_npz function "
    "call, or by setting the --implicit_ids flag in the CLI"
)


class BaseGraph:
    """Node-ID registry plus common graph properties.

    Reference contract: ``src/pecanpy/graph.py:19-105``.
    """

    def __init__(self):
        self._node_ids: List[str] = []
        self._node_idmap: Dict[str, int] = {}

    @property
    def nodes(self) -> List[str]:
        """List of node IDs, index-aligned with the graph."""
        return self._node_ids

    @property
    def num_nodes(self) -> int:
        return len(self._node_ids)

    @property
    def num_edges(self) -> int:
        raise NotImplementedError(
            f"{type(self).__name__} does not track edges directly; use a "
            "derived container such as SparseGraph or DenseGraph.",
        )

    @property
    def density(self) -> float:
        """Edge density E / (N * (N - 1))."""
        n = self.num_nodes
        return self.num_edges / (n * (n - 1))

    def set_node_ids(
        self,
        node_ids: Optional[Sequence[str]],
        implicit_ids: bool = False,
        num_nodes: Optional[int] = None,
    ):
        """Install the node-ID list and the reverse ID -> index map.

        When ``node_ids`` is None (or implicit IDs are forced), node IDs
        become the canonical string ordering ``"0", "1", ...`` and a warning
        is emitted unless ``implicit_ids`` confirms the behavior.
        """
        if node_ids is not None and not implicit_ids:
            self._node_ids = list(node_ids)
        else:
            if num_nodes is None:
                raise ValueError(
                    "Need to specify `num_nodes` when setting implicit node IDs.",
                )
            self._node_ids = [str(i) for i in range(num_nodes)]
            if not implicit_ids:
                warnings.warn(IMPLICIT_IDS_WARNING, stacklevel=2)
        self._node_idmap = {nid: i for i, nid in enumerate(self._node_ids)}


def _parse_edge_line(
    line: str,
    weighted: bool,
    delimiter: str,
) -> Tuple[str, str, float]:
    """Split one edgelist line into (head, tail, weight).

    Weighted graphs require exactly three columns (``graph.py:160-179``);
    unweighted edges get weight 1.0 regardless of extra columns.
    """
    fields = line.strip().split(delimiter)
    head, tail = fields[0].strip(), fields[1].strip()
    if not weighted:
        return head, tail, 1.0
    if len(fields) != 3:
        raise ValueError(
            f"Expecting three columns in the edge list file for a "
            f"weighted graph, got {len(fields)} instead: {line!r}",
        )
    return head, tail, float(fields[-1])


class AdjlstGraph(BaseGraph):
    """Adjacency-list builder used for edge list I/O.

    Holds per-node ``{neighbor_index: weight}`` maps; converts to CSR or
    dense adjacency. This container never touches the device — it exists to
    implement the reference's parsing/dedup/warning semantics exactly.
    """

    def __init__(self):
        super().__init__()
        self._adj: List[Dict[int, float]] = []
        self._num_edges: int = 0

    @property
    def num_edges(self) -> int:
        return self._num_edges

    @property
    def edges_iter(self) -> Iterator[Tuple[int, int, float]]:
        """Yield (head_idx, tail_idx, weight), tails ascending per head."""
        for head, nbr_map in enumerate(self._adj):
            for tail in sorted(nbr_map):
                yield head, tail, nbr_map[tail]

    @property
    def edges(self) -> List[Tuple[int, int, float]]:
        return list(self.edges_iter)

    def add_node(self, node_id: str):
        """Register a node if new; silently pass otherwise."""
        if node_id not in self._node_idmap:
            self._node_idmap[node_id] = len(self._node_ids)
            self._node_ids.append(node_id)
            self._adj.append({})

    def get_node_idx(self, node_id: str) -> int:
        """Index of ``node_id``, creating the node on first sight."""
        self.add_node(node_id)
        return self._node_idmap[node_id]

    def _set_edge(self, idx1: int, idx2: int, weight: float):
        self._adj[idx1][idx2] = weight
        self._num_edges += 1

    def add_edge(
        self,
        id1: str,
        id2: str,
        weight: float = 1.0,
        directed: bool = False,
    ):
        """Insert an edge (both directions when undirected).

        Non-positive weights are dropped with a warning; duplicate edges
        with a conflicting weight warn and keep the newest value.
        """
        if weight <= 0:
            warnings.warn(
                f"Non-positive edge ignored: w({id1},{id2}) = {weight}",
                RuntimeWarning,
                stacklevel=2,
            )
            return

        idx1, idx2 = self.get_node_idx(id1), self.get_node_idx(id2)
        existing = self._adj[idx1].get(idx2)
        if existing is not None and existing != weight:
            warnings.warn(
                f"edge from {id1} to {id2} exists, with value of "
                f"{existing:.2f}. Now overwrite to {weight:.2f}.",
                RuntimeWarning,
                stacklevel=2,
            )

        self._set_edge(idx1, idx2, weight)
        if not directed:
            self._set_edge(idx2, idx1, weight)

    def read(
        self,
        path: str,
        weighted: bool,
        directed: bool,
        delimiter: str = "\t",
    ):
        """Parse an ``.edg`` file into this adjacency list."""
        with open(path, encoding="utf-8") as f:
            for line in f:
                head, tail, weight = _parse_edge_line(line, weighted, delimiter)
                self.add_edge(head, tail, weight, directed)

    def save(self, path: str, unweighted: bool = False, delimiter: str = "\t"):
        """Write the graph back out as an ``.edg`` edge list."""
        with open(path, "w", encoding="utf-8") as f:
            for head, tail, weight in self.edges_iter:
                cols = [self._node_ids[head], self._node_ids[tail]]
                if not unweighted:
                    cols.append(str(weight))
                f.write(delimiter.join(cols) + "\n")

    def to_csr(self) -> CSR:
        """Build the CSR triple; neighbor indices ascend within each row."""
        degrees = np.fromiter(
            (len(m) for m in self._adj), dtype=np.uint32, count=len(self._adj)
        )
        indptr = np.zeros(len(self._adj) + 1, dtype=np.uint32)
        np.cumsum(degrees, out=indptr[1:])

        nnz = int(indptr[-1])
        indices = np.empty(nnz, dtype=np.uint32)
        data = np.empty(nnz, dtype=np.float32)
        for i, nbr_map in enumerate(self._adj):
            row = sorted(nbr_map)
            lo, hi = indptr[i], indptr[i + 1]
            indices[lo:hi] = row
            data[lo:hi] = [nbr_map[j] for j in row]
        return indptr, indices, data

    def to_dense(self) -> AdjMat:
        """Build the dense float adjacency matrix."""
        n = self.num_nodes
        mat = np.zeros((n, n))
        for head, nbr_map in enumerate(self._adj):
            for tail, weight in nbr_map.items():
                mat[head, tail] = weight
        return mat

    @classmethod
    def from_mat(cls, adj_mat: AdjMat, node_ids: List[str], **kwargs):
        """Build from a dense adjacency matrix; nonzero entries are edges."""
        g = cls(**kwargs)
        for node_id in node_ids:
            g.add_node(node_id)
        for idx1, idx2 in zip(*np.nonzero(adj_mat)):
            g._set_edge(int(idx1), int(idx2), float(adj_mat[idx1, idx2]))
        return g


class SparseGraph(BaseGraph):
    """CSR graph container (``indptr`` u32, ``indices`` u32, ``data`` f32).

    Reference contract: ``src/pecanpy/graph.py:389-528``.
    """

    def __init__(self):
        super().__init__()
        self.indptr: Optional[np.ndarray] = None
        self.indices: Optional[np.ndarray] = None
        self.data: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        if self.indptr is None:
            raise ValueError("Empty graph.")
        return int(self.indptr[-1])

    def read_edg(
        self,
        path: str,
        weighted: bool,
        directed: bool,
        delimiter: str = "\t",
        engine: str = "auto",
    ):
        """Parse an edge list and store it in CSR form.

        Args:
            engine: ``"auto"`` and ``"python"`` run the reference-parity
                pure-Python parser (per-edge warnings). ``"native"`` names
                the C++ parser of the JAX package, which this package does
                not carry yet (ROADMAP, "Modules to port"); it raises.
        """
        if engine not in ("auto", "python", "native"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "native":
            raise NotImplementedError(
                "the native C++ edgelist parser is not ported yet (ROADMAP "
                "'Modules to port'); use engine='python', which builds the "
                "identical CSR"
            )
        adj = AdjlstGraph()
        adj.read(path, weighted, directed, delimiter)
        self.set_node_ids(adj.nodes)
        self.indptr, self.indices, self.data = adj.to_csr()

    def read_npz(self, path: str, weighted: bool, implicit_ids: bool = False):
        """Load a ``.csr.npz`` file (also accepts scipy-saved CSR npz).

        When unweighted, all edge weights are overwritten with 1.0
        (``graph.py:479-480``).
        """
        raw = np.load(path)
        self.indptr = raw["indptr"].astype(np.uint32)
        self.indices = raw["indices"].astype(np.uint32)
        self.data = raw["data"].astype(np.float32)
        if not weighted:
            self.data[:] = 1.0
        self.set_node_ids(
            raw["IDs"] if "IDs" in raw else None,
            implicit_ids=implicit_ids,
            num_nodes=int(self.indptr.size - 1),
        )

    def save(self, path: str):
        """Save as ``.csr.npz``."""
        np.savez(
            path,
            IDs=self.nodes,
            data=self.data,
            indptr=self.indptr,
            indices=self.indices,
        )

    @classmethod
    def from_adjlst_graph(cls, adjlst_graph: AdjlstGraph, **kwargs):
        """Convert an adjacency-list graph into CSR form."""
        g = cls(**kwargs)
        g.set_node_ids(adjlst_graph.nodes)
        g.indptr, g.indices, g.data = adjlst_graph.to_csr()
        return g

    @classmethod
    def from_mat(cls, adj_mat: AdjMat, node_ids: List[str], **kwargs):
        """Build CSR graph from a dense adjacency matrix and ID list.

        Extra kwargs are forwarded to the constructor — this is how walk-mode
        subclasses receive p/q/etc. through ``from_mat`` (``graph.py:498-528``).
        """
        g = cls(**kwargs)
        g.set_node_ids(node_ids)
        adj = AdjlstGraph.from_mat(adj_mat, node_ids)
        g.indptr, g.indices, g.data = adj.to_csr()
        return g


class DenseGraph(BaseGraph):
    """Dense adjacency container with a derived nonzero mask.

    Reference contract: ``src/pecanpy/graph.py:531-657``. Assigning ``data``
    refreshes ``nonzero`` so the two can never drift apart.
    """

    def __init__(self):
        super().__init__()
        self._data: Optional[AdjMat] = None
        self._nonzero: Optional[np.ndarray] = None

    @property
    def data(self) -> Optional[AdjMat]:
        return self._data

    @data.setter
    def data(self, mat: AdjMat):
        self._data = mat.astype(float)
        self._nonzero = self._data != 0

    @property
    def nonzero(self) -> Optional[np.ndarray]:
        return self._nonzero

    @property
    def num_edges(self) -> int:
        if self._nonzero is None:
            raise ValueError("Empty graph.")
        return int(self._nonzero.sum())

    def read_npz(self, path: str, weighted: bool, implicit_ids: bool = False):
        """Load a ``.dense.npz`` file (keys ``data`` and optionally ``IDs``)."""
        raw = np.load(path)
        self.data = raw["data"]
        if not weighted:
            self.data = self._nonzero * 1.0
        self.set_node_ids(
            raw["IDs"] if "IDs" in raw else None,
            implicit_ids=implicit_ids,
            num_nodes=self.data.shape[0],
        )

    def read_edg(
        self,
        path: str,
        weighted: bool,
        directed: bool,
        delimiter: str = "\t",
    ):
        """Parse an edge list into a dense adjacency matrix."""
        adj = AdjlstGraph()
        adj.read(path, weighted, directed, delimiter)
        self.set_node_ids(adj.nodes)
        self.data = adj.to_dense()

    def save(self, path: str):
        """Save as ``.dense.npz``."""
        np.savez(path, data=self.data, IDs=self.nodes)

    @classmethod
    def from_adjlst_graph(cls, adjlst_graph: AdjlstGraph, **kwargs):
        """Convert an adjacency-list graph into dense form."""
        g = cls(**kwargs)
        g.set_node_ids(adjlst_graph.nodes)
        g.data = adjlst_graph.to_dense()
        return g

    @classmethod
    def from_mat(cls, adj_mat: AdjMat, node_ids: List[str], **kwargs):
        """Build dense graph from adjacency matrix and ID list."""
        g = cls(**kwargs)
        g.data = adj_mat
        g.set_node_ids(node_ids)
        return g
