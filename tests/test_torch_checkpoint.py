"""Checkpoint/resume and ``--profile`` of the PyTorch port.

Mirrors ``tests/test_checkpoint_surface.py`` through the port's surfaces:
a run split by ``max_steps`` and resumed from its checkpoint ends bit
for bit where an uninterrupted run ends, through ``embed`` (f32 and bf16
tables, stored and streaming walks) and through the CLI. Stale or foreign
checkpoints are refused: another RNG scheme, or a directory written by
the JAX package's orbax checkpointer. Snapshots land atomically (leftover
temporary files are ignored) and ``max_to_keep`` holds. ``--profile DIR``
writes a Chrome trace that parses and holds events.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from pecanpy_tpu_torch import cli, pecanpy
from pecanpy_tpu_torch.models import sgns
from pecanpy_tpu_torch.utils.checkpoint import SGNSCheckpointer


def _toy_adj(n=24, seed=3):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < 0.25
    np.fill_diagonal(mask, False)
    upper = np.triu(np.where(mask, rng.uniform(0.5, 2.0, (n, n)), 0.0))
    adj = upper + upper.T
    for i in range(n):  # no isolated nodes
        if adj[i].sum() == 0:
            j = (i + 1) % n
            adj[i, j] = adj[j, i] = 1.0
    return adj


# 48 walks in chunks of 8: 6 chunk-steps an epoch, 12 in the run
EMBED_KW = dict(dim=8, num_walks=2, walk_length=5, window_size=3, epochs=2, batch_walks=8)


def _graph(**kw):
    adj = _toy_adj()
    ids = [str(i) for i in range(adj.shape[0])]
    return pecanpy.SparseOTF.from_mat(
        adj, ids, p=0.5, q=2.0, random_state=7, device="cpu", **kw
    )


def _embed(table_dtype, **kw):
    if table_dtype == "bfloat16":
        with pytest.warns(UserWarning, match="bfloat16 tables on the CPU"):
            return _graph().embed(**EMBED_KW, table_dtype=table_dtype, **kw)
    return _graph().embed(**EMBED_KW, table_dtype=table_dtype, **kw)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_embed_resume_bit_identical(tmp_path, table_dtype):
    full = _embed(table_dtype)
    ckdir = str(tmp_path / "ck")
    partial = _embed(table_dtype, checkpoint_dir=ckdir, checkpoint_every=4, max_steps=7)
    assert not np.array_equal(partial, full)  # genuinely interrupted
    ck = SGNSCheckpointer(ckdir)
    assert ck.steps() == [4]
    w_in, w_out, meta = ck.restore()
    assert w_in.dtype == w_out.dtype == getattr(torch, table_dtype)
    assert meta == {"next_step": 4, "rng_scheme": sgns.RNG_SCHEME}
    resumed = _embed(table_dtype, checkpoint_dir=ckdir, checkpoint_every=4)
    np.testing.assert_array_equal(resumed, full)
    assert ck.steps() == [4, 8, 12]


def test_streaming_resume_bit_identical(tmp_path):
    """Three walk buffers of 16 walks an epoch, resumed mid-buffer."""
    kw = dict(streaming=True, table_dtype="float32")
    full = _graph(walker_batch=16).embed(**EMBED_KW, **kw)
    ckdir = str(tmp_path / "ck")
    _graph(walker_batch=16).embed(
        **EMBED_KW, **kw, checkpoint_dir=ckdir, checkpoint_every=5, max_steps=5
    )
    resumed = _graph(walker_batch=16).embed(
        **EMBED_KW, **kw, checkpoint_dir=ckdir, checkpoint_every=5
    )
    np.testing.assert_array_equal(resumed, full)
    assert SGNSCheckpointer(ckdir).steps() == [5, 10]


def test_cli_kill_and_resume_bit_identical(tmp_path, karate_edg):
    common = [
        "--input", karate_edg, "--mode", "SparseOTF", "--p", "0.5", "--q", "2",
        "--dimensions", "8", "--walk-length", "5", "--num-walks", "2",
        "--window-size", "3", "--epochs", "2", "--random_state", "7",
        "--table-dtype", "float32", "--device", "cpu",
    ]
    out_full = str(tmp_path / "full.emb.npz")
    cli.main(common + ["--output", out_full])
    ckdir = str(tmp_path / "ck")
    out_partial = str(tmp_path / "partial.emb.npz")
    cli.main(common + ["--output", out_partial, "--checkpoint-dir", ckdir,
                       "--checkpoint-every", "1", "--max-steps", "1"])
    out_resumed = str(tmp_path / "resumed.emb.npz")
    cli.main(common + ["--output", out_resumed, "--checkpoint-dir", ckdir,
                       "--checkpoint-every", "1"])
    full = np.load(out_full)["data"]
    assert not np.array_equal(np.load(out_partial)["data"], full)
    np.testing.assert_array_equal(np.load(out_resumed)["data"], full)


def _train_small(ckdir, **kw):
    walks = torch.from_numpy(np.tile(np.arange(6, dtype=np.int32), (8, 1)) % 16)
    eff = torch.full((8,), 6, dtype=torch.int32)
    config = sgns.SGNSConfig(dim=8, window=2, seed=0, table_dtype="float32")
    return sgns.train(walks, eff, 16, config, checkpoint_dir=ckdir, **kw)


def test_rng_scheme_mismatch_refuses_resume(tmp_path):
    ckdir = str(tmp_path / "stale")
    SGNSCheckpointer(ckdir).save(
        1, torch.zeros(16, 8), torch.zeros(16, 8),
        {"next_step": 1, "rng_scheme": "some-older-scheme"},
    )
    with pytest.raises(ValueError, match="RNG scheme"):
        _train_small(ckdir)


def test_jax_checkpoint_directory_refused(tmp_path):
    """A directory the JAX package's orbax checkpointer wrote is not a
    fresh start: both the checkpointer and the trainer refuse it."""
    pytest.importorskip("orbax.checkpoint")
    from pecanpy_tpu.models import sgns as jsgns
    from pecanpy_tpu.utils.checkpoint import SGNSCheckpointer as JaxCheckpointer

    ckdir = str(tmp_path / "jax")
    ck = JaxCheckpointer(ckdir)
    ck.save(1, np.zeros((16, 8), np.float32), np.zeros((16, 8), np.float32),
            {"next_step": 1, "rng_scheme": jsgns.RNG_SCHEME})
    ck.close()
    assert os.listdir(ckdir)
    with pytest.raises(ValueError, match="not snapshots of this trainer"):
        SGNSCheckpointer(ckdir)
    with pytest.raises(ValueError, match="not snapshots of this trainer"):
        _train_small(ckdir)


def test_leftover_temporary_ignored_and_max_to_keep(tmp_path):
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    (ckdir / ".tmp-step_9.pt.123").write_bytes(b"half a snapshot")
    ck = SGNSCheckpointer(str(ckdir), max_to_keep=2)
    assert ck.latest_step() is None
    for step in range(1, 6):
        w = torch.full((4, 2), float(step), dtype=torch.bfloat16)
        ck.save(step, w, -w, {"next_step": step, "rng_scheme": sgns.RNG_SCHEME})
    assert ck.steps() == [4, 5] and ck.latest_step() == 5
    w_in, w_out, meta = ck.restore()
    assert w_in.dtype == torch.bfloat16 and torch.equal(w_out, -w_in)
    assert float(w_in[0, 0]) == 5.0 and meta["next_step"] == 5
    assert float(ck.restore(4)[0][0, 0]) == 4.0
    with pytest.raises(ValueError, match="checkpoint_every"):
        _train_small(str(tmp_path / "other"), checkpoint_every=0)


def test_cli_profile_writes_trace(tmp_path, karate_edg):
    prof = tmp_path / "prof"
    cli.main(["--input", karate_edg, "--output", str(tmp_path / "k.emb"),
              "--dimensions", "4", "--walk-length", "5", "--num-walks", "1",
              "--p", "0.5", "--q", "2", "--random_state", "0", "--device", "cpu",
              "--profile", str(prof)])
    traces = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    assert (tmp_path / "k.emb").read_text().startswith("34 4")
