"""Multi-process walking of the port: 2 worker processes over gloo.

As ``tests/test_multihost.py`` does for the JAX package: two subprocess
workers call the port's ``multihost.initialize`` with one coordinator,
build the global mesh, walk the edge partition (the psum exchange without
hubs, the psum exchange through the hub walker, the all-to-all exchange),
and each checks its own rows edge by edge. The workers import torch and
the port only. Also: ``embed(n_devices=2)`` called in place on every
rank of a started group, and the entry points' default device.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pecanpy_tpu_torch import pecanpy
from pecanpy_tpu_torch.parallel import launch, multihost

WORKER = r"""
import sys
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import numpy as np
import torch
torch.set_num_threads(1)
from pecanpy_tpu_torch.ops.layout import device_csr_from_dense
from pecanpy_tpu_torch.parallel import distgraph, multihost
multihost.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid, device="cpu")
mesh = multihost.global_mesh(device="cpu")
assert mesh.shape == {"data": nproc, "model": 1} and mesh.data_rank == pid

rng = np.random.default_rng(0)  # identical graph on every process
n = 16
mask = rng.random((n, n)) < 4.0 / n
np.fill_diagonal(mask, False)
upper = np.triu(np.where(mask, rng.uniform(0.5, 2.0, (n, n)), 0.0))
adj = upper + upper.T
for i in range(n):
    if adj[i].sum() == 0:
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1.0

starts = np.tile(np.arange(n, dtype=np.int32), 8)
for cap, exchange in [(128, "psum"), (5, "psum"), (128, "alltoall")]:
    graph = device_csr_from_dense(adj, degree_cap=cap, device="cpu")
    walks, eff = distgraph.simulate_walks_distributed(
        graph, mesh, starts, walk_length=5, p=0.5, q=2.0, seed=7, exchange=exchange,
    )
    my_walks, my_eff = multihost.local_array(walks), multihost.local_array(eff)
    assert my_walks.shape[0] == starts.size // nproc
    sl = multihost.process_slice(starts.size)
    assert (my_walks[:, 0] == starts[sl]).all()
    for row, m in zip(my_walks, my_eff):
        for a, b in zip(row[: m - 1], row[1:m]):
            assert adj[a, b] != 0, f"proc {pid}: non-edge {a}->{b}"
    print(f"proc {pid} cap={cap} {exchange}: ok", flush=True)
assert "jax" not in sys.modules and not any(
    m == "pecanpy_tpu" or m.startswith("pecanpy_tpu.") for m in sys.modules)
print(f"proc {pid}: PASS", flush=True)
"""


def test_two_process_collective_walks(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"proc {i}: PASS" in out, out


def _embed_in_place(mesh, adj):
    """One rank of a started group: ``embed(n_devices=2)`` in place, each
    process with its own mode object and no ``random_state``."""
    g = pecanpy.SparseOTF.from_mat(adj, [str(i) for i in range(adj.shape[0])],
                                   p=0.5, q=2.0, device="cpu")
    return g.embed(dim=8, num_walks=2, walk_length=5, window_size=3, n_devices=2)


def test_embed_in_place_ranks_share_one_seed():
    """With random_state=None every rank resolves its own seed; the call
    takes rank 0's, so both ranks shuffle, init and walk alike and return
    the same embeddings."""
    rng = np.random.default_rng(3)
    upper = np.triu(np.where(rng.random((16, 16)) < 0.3, 1.0, 0.0), 1)
    adj = upper + upper.T
    adj[np.arange(16), (np.arange(16) + 1) % 16] = 1.0
    adj[(np.arange(16) + 1) % 16, np.arange(16)] = 1.0
    a, b = launch.spawn(_embed_in_place, 2, (adj,), device="cpu")
    assert a.shape == (16, 8) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_entry_points_default_to_the_card(monkeypatch):
    """``spawn`` and ``initialize`` put ranks on the card unless asked for
    the CPU: without one they raise before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(launch.run_calls, 2, ([],))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("localhost:29500", num_processes=2, process_id=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize()
