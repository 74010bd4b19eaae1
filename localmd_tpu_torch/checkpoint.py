"""Pipeline checkpoint/resume (a copy of localmd_tpu/checkpoint.py:25-91).

The reference pipeline cannot resume mid-run (SURVEY.md §5: "Checkpoint /
resume: none"); a crash during the second full-movie pass loses everything.
This module adds stage-granular checkpointing: each completed pipeline stage
persists its outputs to ``<path>.<stage>.npz`` together with a config
fingerprint; on restart, stages whose checkpoints match the fingerprint are
loaded instead of recomputed.

Stages (in pipeline order): ``stats`` (mean/std images), ``background``
(spatial basis), ``thresholds``, ``blocks`` (panels/counts/temporal fits),
``projector`` (mixing matrix P), ``v`` (regressed temporal matrix).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np
import torch


class PipelineCheckpoint:
    def __init__(self, path: Optional[str], fingerprint: Dict):
        """``path`` None disables checkpointing (all ops become no-ops)."""
        self.path = path
        self.fingerprint = self._digest(fingerprint)

    @staticmethod
    def _digest(config: Dict) -> str:
        blob = json.dumps(
            {k: (list(v) if isinstance(v, (tuple, list)) else v)
             for k, v in sorted(config.items())},
            sort_keys=True,
        )
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def _stage_path(self, stage: str) -> str:
        return f"{self.path}.{stage}.npz"

    def has(self, stage: str) -> bool:
        if self.path is None:
            return False
        p = self._stage_path(stage)
        if not os.path.exists(p):
            return False
        try:
            with np.load(p, allow_pickle=False) as data:
                return str(data["__fingerprint__"]) == self.fingerprint
        except Exception:
            return False

    def load(self, stage: str) -> Dict[str, np.ndarray]:
        with np.load(self._stage_path(stage), allow_pickle=False) as data:
            return {k: data[k] for k in data.files if k != "__fingerprint__"}

    def save(self, stage: str, **arrays) -> None:
        if self.path is None:
            return
        host = {
            k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in arrays.items()
        }
        tmp = self._stage_path(stage) + ".tmp.npz"
        np.savez_compressed(tmp, __fingerprint__=self.fingerprint, **host)
        os.replace(tmp, self._stage_path(stage))

    def matching_stages(self, prefix: str) -> list:
        """Names of existing stages starting with ``prefix`` whose
        fingerprint matches the current config (used for sub-stage parts,
        e.g. per-batch block checkpoints ``blocks.part*``)."""
        if self.path is None:
            return []
        out = []
        for p in glob.glob(self._stage_path(prefix + "*")):
            if p.endswith(".tmp.npz"):
                continue
            stage = p[len(self.path) + 1 : -len(".npz")]
            if self.has(stage):
                out.append(stage)
        return sorted(out)

    def discard(self, stage: str) -> None:
        """Remove a stage file (e.g. sub-stage parts once the full stage is
        persisted)."""
        if self.path is None:
            return
        p = self._stage_path(stage)
        if os.path.exists(p):
            os.remove(p)
