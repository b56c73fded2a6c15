"""The PyTorch port's main path as a whole, on the CPU.

``embed`` on the block-model graph of ``tests/test_downstream.py`` must
clear the JAX suite's nearest-centroid micro-F1 gate (0.9); the CLI must
write a valid, reproducible embedding file; the port must never import
jax, and must never pick the CPU on its own.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pecanpy_tpu_torch import cli, pecanpy
from test_downstream import micro_f1_nearest_centroid, sbm_graph

REPO = Path(__file__).resolve().parent.parent


def test_sbm_embed_micro_f1(rng):
    adj, labels = sbm_graph(rng)
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0, device="cpu")
    emb = g.embed(dim=32, num_walks=8, walk_length=30, window_size=5, epochs=3)
    assert emb.shape == (160, 32) and emb.dtype == np.float32
    f1 = micro_f1_nearest_centroid(emb, labels, rng)
    assert f1 >= 0.9, f"micro-F1 {f1:.3f} below 0.9"


def test_port_never_imports_jax():
    code = (
        "import sys, pecanpy_tpu_torch, pecanpy_tpu_torch.pecanpy, "
        "pecanpy_tpu_torch.cli, pecanpy_tpu_torch.models.sgns, "
        "pecanpy_tpu_torch.models.engine, pecanpy_tpu_torch.ops.hubs, "
        "pecanpy_tpu_torch.ops.rejection, pecanpy_tpu_torch.ops.trialkernel, "
        "pecanpy_tpu_torch.experimental, pecanpy_tpu_torch.native, "
        "pecanpy_tpu_torch.native.loader, pecanpy_tpu_torch.utils.evaluate, "
        "pecanpy_tpu_torch.utils.checkpoint, pecanpy_tpu_torch.parallel, "
        "pecanpy_tpu_torch.parallel.mesh, pecanpy_tpu_torch.parallel.multihost, "
        "pecanpy_tpu_torch.parallel.distgraph, pecanpy_tpu_torch.parallel.train, "
        "pecanpy_tpu_torch.parallel.launch; "
        "from pecanpy_tpu_torch.typing import HasNbrs, MoveForward, AdjNonZeroMat; "
        "from pecanpy_tpu_torch.ops.sampling import alias_build, alias_draw; "
        "from pecanpy_tpu_torch.ops.transition import first_order_weights, "
        "node2vec_weights, node2vec_plus_weights, node2vec_pp_weights; "
        "from pecanpy_tpu_torch.utils.checkpoint import checkpointing_available; "
        "from pecanpy_tpu_torch.cli import simulate_walks, learn_embeddings; "
        "from pecanpy_tpu_torch.models.base import Base; "
        "Base.get_noise_thresholds, Base.get_has_nbrs, Base.get_move_forward; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert not any(m == 'pecanpy_tpu' or m.startswith('pecanpy_tpu.') "
        "for m in sys.modules), 'pecanpy_tpu imported'"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    banned = re.compile(
        r"^\s*(import jax|from jax|import pecanpy_tpu\b(?!_torch)"
        r"|from pecanpy_tpu\b(?!_torch))",
        re.M,
    )
    files = list((REPO / "pecanpy_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if banned.search(f.read_text())]
    assert not offenders, offenders


def test_default_device_needs_cuda(monkeypatch):
    """device='cuda' (the default) raises without a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pecanpy.SparseOTF()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--input", "x.edg", "--output", "x.emb"])


def test_cli_karate_reproducible(tmp_path, karate_edg):
    outs = []
    for i in range(2):
        out = tmp_path / f"k{i}.emb"
        cli.main([
            "--input", karate_edg, "--output", str(out), "--dimensions", "16",
            "--walk-length", "10", "--num-walks", "3", "--window-size", "4",
            "--p", "0.5", "--q", "2", "--random_state", "0", "--device", "cpu",
        ])
        outs.append(out.read_bytes())
    lines = outs[0].decode().splitlines()
    assert lines[0] == "34 16" and len(lines) == 35
    assert all(len(line.split()) == 17 for line in lines[1:])
    assert outs[0] == outs[1]
    npz = tmp_path / "k.emb.npz"
    cli.main([
        "--input", karate_edg, "--output", str(npz), "--dimensions", "8",
        "--walk-length", "5", "--num-walks", "2", "--p", "0.5", "--q", "2",
        "--device", "cpu", "--mode", "DenseOTF",
    ])
    data = np.load(npz)
    assert data["data"].shape == (34, 8) and len(data["IDs"]) == 34


@pytest.mark.parametrize("flags", [
    ["--devices", "3", "--model-parallel", "2"],
])
def test_cli_model_parallel_must_divide_devices(flags, karate_edg, tmp_path):
    """Every option is ported now: the multi-device options raise only
    where the JAX CLI raises (a model-parallel size that does not divide
    the devices), before any rank starts."""
    with pytest.raises(ValueError, match="does not divide"):
        cli.main(["--input", karate_edg, "--output", str(tmp_path / "o.emb"),
                  "--dimensions", "4", "--walk-length", "3", "--num-walks", "1",
                  "--p", "0.5", "--device", "cpu", *flags])


def _cli(karate_edg, out, *flags):
    cli.main(["--input", karate_edg, "--output", str(out), "--dimensions", "4",
              "--walk-length", "3", "--num-walks", "1", "--p", "0.5",
              "--random_state", "0", "--device", "cpu", *flags])


@pytest.mark.parametrize("task", ["PreComp", "tocsr"])
def test_cli_ported_options_run(task, karate_edg, tmp_path):
    """``--mode PreComp`` writes one row per karate node; ``--task tocsr``
    writes a CSR archive that embeds when fed back as ``--input``."""
    out = tmp_path / "o.emb"
    if task == "PreComp":
        _cli(karate_edg, out, "--mode", "PreComp")
    else:
        csr = tmp_path / "k.csr.npz"
        _cli(karate_edg, csr, "--task", "tocsr")
        assert np.load(csr)["indptr"].size == 35
        _cli(str(csr), out, "--mode", "SparseOTF")
    lines = out.read_text().splitlines()
    assert lines[0] == "34 4" and len(lines) == 35


def test_cli_walks_and_todense(karate_edg, tmp_path):
    """``--task walks`` writes one walk per node and walk, each consecutive
    pair an edge; ``--task todense`` writes the dense matrix, which the
    experimental Node2vecPlusPlus reads back."""
    walks = tmp_path / "k.walks"
    _cli(karate_edg, walks, "--task", "walks", "--mode", "PreComp", "--num-walks", "2")
    dense = tmp_path / "k.dense.npz"
    _cli(karate_edg, dense, "--task", "todense")
    adj = np.load(dense)["data"]
    ids = [str(i) for i in np.load(dense)["IDs"]]
    lines = walks.read_text().splitlines()
    assert len(lines) == 68
    for line in lines:
        nodes = [ids.index(x) for x in line.split()]
        assert len(nodes) == 4 and all(adj[a, b] != 0 for a, b in zip(nodes, nodes[1:]))
    out = tmp_path / "pp.emb"
    _cli(str(dense), out, "--mode", "Node2vecPlusPlus")
    assert out.read_text().splitlines()[0] == "34 4"


def test_small_corpus_epochs_advisory(rng):
    adj = sbm_graph(rng, blocks=2, per_block=6)[0]
    g = pecanpy.SparseOTF.from_mat(adj, [str(i) for i in range(12)],
                                   random_state=0, device="cpu")
    with pytest.warns(UserWarning, match="epochs=2 matches"):
        g.embed(dim=8, num_walks=2, walk_length=5, window_size=2, epochs=1)


def test_build_dir_is_ignored():
    """Kernel builds land in build/, which git must not track."""
    from pecanpy_tpu_torch.ops import _kernels

    assert _kernels.BUILD_DIR == REPO / "build"
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert os.path.exists(_kernels.CSRC_DIR / "apply.cu")
    assert os.path.exists(_kernels.CSRC_DIR / "trial.cu")
