"""SGNS training checkpoint/resume.

Counterpart of ``pecanpy_tpu/utils/checkpoint.py``, which is built on
orbax and jax: the port writes its own format under the same names. A
snapshot holds both embedding tables (their logical [N, dim] rows, in the
table dtype, so bf16 stays bf16) and the training cursor ``meta`` (JSON:
``next_step`` and the ``rng_scheme`` tag), one ``torch.save`` file per
step, ``step_<n>.pt``.

A snapshot is written under a temporary name and renamed into place with
``os.replace``, so a run killed mid-save never leaves a partial snapshot
that ``latest_step`` would pick; leftover temporary files are ignored. A
directory holding anything else (for example the JAX package's orbax step
directories) is refused rather than taken as a fresh start. There is no
silent skip: a failed save raises.
"""
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from pecanpy_tpu_torch.utils import trace

_SNAPSHOT = re.compile(r"step_(\d+)\.pt")
_TMP_PREFIX = ".tmp-"


def checkpointing_available() -> bool:
    """Can this install checkpoint? Always: snapshots are ``torch.save``
    files (the JAX package's answer depends on orbax being installed)."""
    return True


def verify_rng_scheme(meta: Dict[str, Any], expected: str) -> None:
    """Refuse to resume across an RNG-stream derivation change.

    Each trainer stamps its checkpoints with the version tag of its draw
    derivation. Resuming a checkpoint written under a different scheme
    would silently continue training on a different corpus/schedule than
    the run that wrote it, so a mismatch is a hard error.
    """
    found = meta.get("rng_scheme")
    if found != expected:
        raise ValueError(
            f"checkpoint was written under RNG scheme {found!r} but this "
            f"trainer derives its streams under {expected!r}; resuming "
            "would train on a different corpus/schedule than the "
            "original run. Start fresh (delete or relocate the "
            "checkpoint directory), or rerun with the matching package "
            "version."
        )


class SGNSCheckpointer:
    """Manages a directory of numbered SGNS training snapshots.

    Args:
        directory: created if missing; must hold only this class's
            snapshots (and leftover temporary files).
        max_to_keep: the newest snapshots kept; older ones are deleted
            after each save.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        foreign = sorted(
            e for e in os.listdir(self.directory)
            if not e.startswith(_TMP_PREFIX) and not _SNAPSHOT.fullmatch(e)
        )
        if foreign:
            raise ValueError(
                f"checkpoint directory {self.directory} holds entries that are "
                f"not snapshots of this trainer ({', '.join(foreign[:3])}"
                f"{', ...' if len(foreign) > 3 else ''}), for example a "
                "checkpoint of the JAX package; use an empty directory"
            )

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def steps(self):
        """The snapshot steps in the directory, ascending."""
        found = (_SNAPSHOT.fullmatch(e) for e in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(
        self,
        step: int,
        w_in: torch.Tensor,
        w_out: torch.Tensor,
        meta: Dict[str, Any],
    ):
        """Snapshot tables + training cursor at ``step`` (a chunk-step
        count), then keep only the newest ``max_to_keep``."""
        with trace.sync("pecanpy.checkpoint.table_read"):
            w_in = w_in.detach().cpu()
        with trace.sync("pecanpy.checkpoint.table_read"):
            w_out = w_out.detach().cpu()
        state = {"w_in": w_in, "w_out": w_out, "meta": json.dumps(meta)}
        final = self._path(step)
        tmp = os.path.join(
            self.directory, f"{_TMP_PREFIX}{os.path.basename(final)}.{os.getpid()}"
        )
        try:
            with open(tmp, "wb") as f:
                torch.save(state, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(
        self, step: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
        """Load (w_in, w_out, meta) from ``step`` (default: latest), the
        tables as host tensors in their stored dtype."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return state["w_in"], state["w_out"], json.loads(state["meta"])

    def close(self):
        """Nothing is held open between calls (kept for the JAX package's
        interface)."""
