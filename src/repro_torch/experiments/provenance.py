"""Provenance stamping for experiment artifacts (port of
``repro/experiments/provenance.py``).

Same mapping as the reference — spec hash, config path and hash, git
tree, seed and RNG salts, requested geometry, wall-clock — except that
``observed`` records torch's view of the device the run actually used
(platform ``gpu``/``cpu``, the card's name, the visible device count),
not jax's.  Rows carry none of this.
"""
from __future__ import annotations

import hashlib
import subprocess
import sys
import time

import torch

from ..core.downtime_batched import _SIZE_SALT

#: the client-latency engine's key-popularity salt
#: (repro/core/client_latency.py:_KEY_SALT), kept here until that engine
#: is ported so the artifact's RNG identity matches the reference's
_KEY_SALT = 0xC2B2AE35


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def git_revision(cwd: str = "."):
    """(sha, dirty) of the enclosing checkout, or (None, None) outside
    one — provenance must never make a run fail."""
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, check=True).stdout.strip()
        dirty = bool(subprocess.run(
            ["git", "status", "--porcelain"], cwd=cwd,
            capture_output=True, text=True, check=True).stdout.strip())
        return sha, dirty
    except (OSError, subprocess.CalledProcessError):
        return None, None


def rng_salts() -> dict:
    """The counter-RNG salt constants that, with the seed, identify every
    variate stream an experiment draws (ARCHITECTURE invariant 1)."""
    return {"size": _SIZE_SALT, "key": _KEY_SALT}


def device_geometry(device="cuda") -> dict:
    """The device a run used, as torch sees it: platform ``gpu`` or
    ``cpu``, the card's name, and the visible device count."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu",
                "device_name": torch.cuda.get_device_name(dev),
                "device_count": torch.cuda.device_count()}
    return {"platform": "cpu", "device_name": None, "device_count": 1}


def build_provenance(spec, *, config_path=None, wall_s=None,
                     started_unix=None, device="cuda") -> dict:
    """The ``meta.provenance`` mapping for one run of ``spec`` on
    `device`."""
    sha, dirty = git_revision()
    prov = {
        "spec_sha256": spec.content_hash(),
        "config_path": str(config_path) if config_path else None,
        "config_sha256": (file_sha256(config_path)
                          if config_path else None),
        "git_sha": sha,
        "git_dirty": dirty,
        "seed": spec.seed,
        "rng_salts": rng_salts(),
        "requested": {"backend": spec.backend, "devices": spec.devices,
                      "trials": spec.trials},
        "observed": device_geometry(device),
        "python": sys.version.split()[0],
        "started_unix": started_unix if started_unix is not None
        else time.time(),
        "wall_s": wall_s,
    }
    return prov
