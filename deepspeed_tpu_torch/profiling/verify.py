"""Program dumps: each recorded phase of a run as a JSON sidecar under
``<run_dir>/programs/`` (port of ``deepspeed_tpu/profiling/verify.py``'s
:class:`ProgramDumper`).

The JAX dumper writes each compiled program's HLO (``<name>.hlo``) and a
sidecar with the donation, mesh and comm metadata, which the offline
DSP6xx verifier and the doctor re-analyse.  The port has no HLO: the
overlap summary is computed from the dispatch stream while the phase
runs (:mod:`.overlap`), so the sidecar holds the phase's comm-ledger
entry, the engine's context (:meth:`program_verify_context`: mesh, param
bytes, the declared host stream and collective schedule, the card) and
the UNTRUNCATED summary (every node), and no ``.hlo`` is written.
:func:`load_run_programs` reads the sidecars back; the doctor
(:mod:`.doctor`) takes its budget from them.

Rank 0 writes (one mesh, one program set); a write that fails is logged
and skipped (a full disk must never take training down).  The DSP6xx
program verifier (:func:`verify_engine_programs`, :func:`verify_run_dir`)
reads HLO passes that have no PyTorch form yet: both raise
:class:`NotImplementedError` naming ROADMAP A12 step 6.
"""

import json
import os

from ..utils.logging import logger

PROGRAMS_DIRNAME = "programs"
SIDECAR_SCHEMA_VERSION = 1
SIDECAR_SUFFIX = ".json"

DSP_UNPORTED = ("the DSP6xx program verifier reads compiled HLO, which the "
                "port does not have: ROADMAP A12 step 6")


def programs_dir(run_dir):
    return os.path.join(str(run_dir), PROGRAMS_DIRNAME)


class ProgramDumper:
    """Writes ``<run_dir>/programs/<name>.json`` for each phase the comm
    ledger records (``ledger.dumper``): ``{sidecar_schema_version,
    name, entry, context, overlap}``.  Only ``rank`` 0 writes."""

    def __init__(self, run_dir, rank=0):
        self.run_dir = str(run_dir)
        self.rank = int(rank)

    @property
    def programs_dir(self):
        return programs_dir(self.run_dir)

    def dump(self, name, entry, summary, context=None):
        """Write one phase's sidecar (tmp + ``os.replace``: a reader
        never sees a torn file).  Returns its path, or None."""
        if self.rank != 0:
            return None
        payload = {"sidecar_schema_version": SIDECAR_SCHEMA_VERSION,
                   "name": str(name),
                   "entry": {k: v for k, v in (entry or {}).items()
                             if k != "overlap"},
                   "context": dict(context or {}),
                   "overlap": summary}
        path = os.path.join(self.programs_dir, f"{name}{SIDECAR_SUFFIX}")
        try:
            os.makedirs(self.programs_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, sort_keys=True,
                          default=str)
            os.replace(tmp, path)
        except OSError as e:
            logger.debug("program dump to %s failed: %s", self.programs_dir,
                         e)
            return None
        return path


def load_run_programs(run_dir):
    """``{name: sidecar}`` from ``<run_dir>/programs/*.json``.  Raises
    ``FileNotFoundError`` when the directory or its sidecars are missing
    and ``ValueError`` on a malformed one (the doctor's usage errors)."""
    pdir = programs_dir(run_dir)
    if not os.path.isdir(pdir):
        raise FileNotFoundError(
            f"{pdir}: no program dumps (run with telemetry and "
            f"profiling.program_dump)")
    out = {}
    for fname in sorted(os.listdir(pdir)):
        if not fname.endswith(SIDECAR_SUFFIX):
            continue
        path = os.path.join(pdir, fname)
        try:
            with open(path, encoding="utf-8") as f:
                side = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: unreadable program sidecar: {e}")
        if not isinstance(side, dict) or "overlap" not in side \
                or "name" not in side:
            raise ValueError(f"{path}: not a program sidecar")
        out[str(side["name"])] = side
    if not out:
        raise FileNotFoundError(f"{pdir}: no program sidecars")
    return out


def verify_engine_programs(engine):
    """The JAX ``engine.verify_programs()``: not ported."""
    raise NotImplementedError(DSP_UNPORTED)


def verify_run_dir(run_dir):
    """The JAX offline ``dslint --programs`` verification: not ported."""
    raise NotImplementedError(DSP_UNPORTED)
