"""Chaos harness: deterministic, seeded fault injection for testing the
resilience subsystem against the failures it claims to survive (port of
``deepspeed_tpu/resilience/chaos.py``).

Every fault a ``ChaosMonkey`` injects is reproducible from its seed (or
from an explicit step list), so a chaos test failure replays exactly.
Faults mirror the real-world menagerie:

- ``nan_steps`` — poison every float leaf of the batch with NaN (a bad
  record / overflowed activation burst: non-finite loss AND gradients);
- ``sigterm_steps`` — synthetic preemption notice, delivered to this
  process right before the step runs;
- ``kill_steps`` — a host loss: the process dies mid-step (default
  SIGKILL — no handler runs, exactly like a yanked preemptible VM);
  the launcher's elastic supervisor reads the signal death as lost
  capacity and resizes the fleet;
- ``hang_steps`` — the step wedges (stuck collective / dead remote
  attachment): blocks on an event (test-controlled) or sleeps.  With
  ``target_rank`` set, ONE rank of a fleet wedges before entering the
  step while its peers proceed into the collective region and block
  behind it — the exact failure the integrity plane's hang quorum
  exists to turn into one eviction instead of N watchdog timeouts;
- ``bitflip_steps`` — silent data corruption: ONE seeded element of
  the targeted rank's master (or optimizer) state gets a bit flipped
  right before the step pulls its batch, with no crash, no NaN, no log
  line (across data-parallel replicas only the fingerprint consensus
  of :mod:`.integrity` sees it);

Rank-targetable faults (``kill_steps``/``sigterm_steps``/
``hang_steps``/``bitflip_steps``) hit a SPECIFIC rank: pass
``rank=<this process's rank>`` and ``target_rank=<victim>`` and only
the victim injects — the chaos schedule stays identical across the
fleet (same seed everywhere), so "corrupt rank 3 at step k"
reproduces exactly.
- :meth:`corrupt_checkpoint` — flip bytes in a committed payload file
  (bit rot / torn storage);
- :meth:`torn_tmp_dir` — fabricate a half-written ``<tag>.tmp`` dir (a
  writer killed mid-commit);
- :meth:`delayed_commit` / :meth:`crash_mid_save` — context managers
  hooking the atomic writer to stall or die between payload files.

Batch-level injection (wrapping the data iterator) is deliberate: it
drives the REAL production path — model forward produces NaN loss, the
backward produces NaN grads, the step's guard skips the update, the
host guard escalates — rather than monkeypatching engine internals.
The state-level faults (:meth:`ChaosMonkey.bitflip_state`,
:meth:`ChaosMonkey.bitflip_params`) flip one bit of a torch tensor in
place: the engine's flat master or optimizer buffer, or one leaf of an
inference engine's param dict.
"""

import contextlib
import os
import signal
import time

import numpy as np
import torch

from ..checkpoint import constants as ckpt_const
from ..checkpoint import writer as ckpt_writer
from ..utils.params import tree_leaves


class ChaosMonkey:
    """Seeded fault injector.  ``log`` records every injected fault as
    ``(pull_index, kind)`` so tests can assert the schedule fired."""

    def __init__(self, seed=0):
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self.log = []

    # ------------------------------------------------------------- plan
    def schedule_steps(self, n_steps, n_faults):
        """``n_faults`` distinct step indices in ``[0, n_steps)``, drawn
        from the seeded stream — same seed, same schedule."""
        n_faults = min(int(n_faults), int(n_steps))
        picks = self._rng.choice(int(n_steps), size=n_faults, replace=False)
        return tuple(sorted(int(i) for i in picks))

    # ------------------------------------------------- batch-level faults
    @staticmethod
    def nan_batch(batch):
        """Every float leaf replaced with NaN (structure/dtypes intact)."""
        def poison(x):
            x = np.asarray(x)
            if np.issubdtype(x.dtype, np.floating):
                return np.full_like(x, np.nan)
            return x

        if isinstance(batch, (tuple, list)):
            return type(batch)(ChaosMonkey.nan_batch(b) for b in batch)
        if isinstance(batch, dict):
            return {k: ChaosMonkey.nan_batch(v) for k, v in batch.items()}
        return poison(batch)

    def wrap_iter(self, data_iter, nan_steps=(), sigterm_steps=(),
                  hang_steps=(), hang_event=None, hang_secs=None,
                  kill_steps=(), kill_signal=None, bitflip_steps=(),
                  bitflip_engine=None, bitflip_field="master", rank=0,
                  target_rank=None):
        """Wrap a batch iterator, injecting faults at the given PULL
        indices (0-based; with gradient accumulation one optimizer step
        pulls ``acc`` batches).  ``hang_steps`` blocks on ``hang_event``
        when given (the test releases it), else sleeps ``hang_secs``.

        ``kill_steps`` kills THIS process with ``kill_signal`` (default
        SIGKILL: unhandleable, the preempted-host failure mode — the
        elastic supervisor's respawn trigger).  ``bitflip_steps`` calls
        :meth:`bitflip_state` on ``bitflip_engine`` — the silent-data-
        corruption fault the fingerprint consensus must catch.  Every
        rank-targetable fault (kill, sigterm, hang, bitflip) honors
        ``target_rank``: when set, only the process whose ``rank``
        matches injects it, so a fleet sharing one seeded schedule
        hits exactly one rank mid-step.  The targeted hang models a
        rank wedging BEFORE it enters the step: its peers proceed into
        the collective region and block behind it, which is where the
        hang-quorum heartbeat (not N local watchdogs) must recover."""
        nan_steps = frozenset(nan_steps)
        sigterm_steps = frozenset(sigterm_steps)
        hang_steps = frozenset(hang_steps)
        kill_steps = frozenset(kill_steps)
        bitflip_steps = frozenset(bitflip_steps)
        assert not bitflip_steps or bitflip_engine is not None, (
            "bitflip_steps needs bitflip_engine (whose state to corrupt)")
        if kill_signal is None:
            kill_signal = signal.SIGKILL
        targeted = target_rank is None or int(rank) == int(target_rank)

        def gen():
            for i, batch in enumerate(data_iter):
                if i in kill_steps and targeted:
                    self.log.append((i, "kill"))
                    os.kill(os.getpid(), kill_signal)
                if i in sigterm_steps and targeted:
                    self.log.append((i, "sigterm"))
                    signal.raise_signal(signal.SIGTERM)
                if i in hang_steps and targeted:
                    self.log.append((i, "hang"))
                    if hang_event is not None:
                        hang_event.wait()
                    elif hang_secs is not None:
                        time.sleep(hang_secs)
                if i in bitflip_steps and targeted:
                    self.bitflip_state(bitflip_engine, field=bitflip_field)
                if i in nan_steps:
                    self.log.append((i, "nan"))
                    batch = self.nan_batch(batch)
                yield batch

        return gen()

    # ------------------------------------------------- state-level faults
    def _flip_one_bit(self, t):
        """Flip ONE seeded bit of one seeded element of tensor ``t``, in
        place.  Returns ``(flat_index, bit)``."""
        nbits = 8 * t.element_size()
        words = {64: torch.int64, 32: torch.int32, 16: torch.int16,
                 8: torch.uint8}[nbits]
        flat = t.view(-1).view(words)
        idx = int(self._rng.integers(0, flat.numel()))
        bit = int(self._rng.integers(0, nbits))
        mask = 1 << bit
        if words != torch.uint8 and bit == nbits - 1:
            mask -= 1 << nbits  # the sign bit of a signed word
        with torch.no_grad():
            flat[idx] ^= mask
        return idx, bit

    def bitflip_state(self, engine, field="master"):
        """Flip ONE seeded bit of one element of the engine's flat master
        (``field="master"``, the default) or of one of its flat optimizer
        buffers (``"exp_avg"``, ``"exp_avg_sq"``) — a cosmic-ray/SDC
        event: no crash, no NaN, nothing in the logs.  The compute params
        take it at the next step's cast.  Returns ``(flat_index, bit)``
        for the post-mortem."""
        buf = (engine.master if field == "master"
               else getattr(engine.opt_state, field))
        idx, bit = self._flip_one_bit(buf)
        self.log.append((f"{field}[{idx}]", "bitflip"))
        return idx, bit

    def bitflip_params(self, engine):
        """Serving-side SDC: flip ONE seeded bit of one element of one
        seeded leaf of ``engine.params`` (the inference engine's param
        dict, walked in its tree order).  Greedy decode is deterministic,
        so from this moment the replica's tokens silently diverge.
        Returns ``(leaf_index, flat_index, bit)`` for the post-mortem."""
        _, leaves = tree_leaves(engine.params)
        leaf_i = int(self._rng.integers(0, len(leaves)))
        idx, bit = self._flip_one_bit(leaves[leaf_i])
        self.log.append((f"params[{leaf_i}][{idx}]", "bitflip"))
        return leaf_i, idx, bit

    def wrap_engine_step(self, engine, kill_steps=(), kill_signal=None,
                         hang_steps=(), hang_event=None, hang_secs=None,
                         bitflip_steps=(), rank=0, target_rank=None):
        """Serving twin of :meth:`wrap_iter`: monkeypatch
        ``engine.step`` so faults fire at the given STEP-CALL indices
        (0-based count of front-end iterations on this replica).  The
        fault menu mirrors the serving chaos e2e's three legs — kill
        (host loss mid-serve: SIGKILL, no handler, KV cache gone),
        hang (one decode iteration wedges; the peers' freshness-quorum
        heartbeat must convict THIS replica, not time out N times),
        and bitflip (:meth:`bitflip_params` — silent weight corruption
        only the fingerprint vote can see).  Rank-targeting works as in
        :meth:`wrap_iter`: same seeded schedule fleet-wide, only the
        ``target_rank`` process injects.  Returns the wrapped engine."""
        kill_steps = frozenset(kill_steps)
        hang_steps = frozenset(hang_steps)
        bitflip_steps = frozenset(bitflip_steps)
        if kill_signal is None:
            kill_signal = signal.SIGKILL
        targeted = target_rank is None or int(rank) == int(target_rank)
        inner_step = engine.step
        counter = {"i": 0}

        def chaotic_step():
            i = counter["i"]
            counter["i"] += 1
            if i in kill_steps and targeted:
                self.log.append((i, "kill"))
                os.kill(os.getpid(), kill_signal)
            if i in hang_steps and targeted:
                self.log.append((i, "hang"))
                if hang_event is not None:
                    hang_event.wait()
                elif hang_secs is not None:
                    time.sleep(hang_secs)
            if i in bitflip_steps and targeted:
                self.bitflip_params(engine)
            return inner_step()

        engine.step = chaotic_step
        return engine

    # --------------------------------------------- checkpoint-level faults
    def corrupt_checkpoint(self, ckpt_dir,
                           filename=ckpt_const.OPTIM_STATES_NPZ, nbytes=1):
        """Flip ``nbytes`` seeded-random bytes of a committed payload
        file; ``verify_checkpoint``/``verify_on_load`` must catch it."""
        path = os.path.join(str(ckpt_dir), filename)
        data = bytearray(open(path, "rb").read())
        for off in self._rng.integers(0, len(data), size=int(nbytes)):
            data[int(off)] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(data))
        self.log.append((filename, "corrupt"))
        return path

    def torn_tmp_dir(self, save_dir, tag):
        """Fabricate the wreckage of a writer killed mid-commit: a
        ``<tag>.tmp`` dir holding one truncated payload file."""
        tmp = os.path.join(str(save_dir), str(tag) + ckpt_const.TMP_SUFFIX)
        os.makedirs(tmp, exist_ok=True)
        junk = self._rng.bytes(64)
        with open(os.path.join(tmp, ckpt_const.MODEL_STATES_NPZ), "wb") as f:
            f.write(junk)
        self.log.append((tag, "torn_tmp"))
        return tmp

    @contextlib.contextmanager
    def delayed_commit(self, delay_secs=None, gate=None,
                       at_file=ckpt_const.META_JSON):
        """While active, the atomic writer stalls on ``at_file`` —
        blocking on ``gate`` (a ``threading.Event``) when given, else
        sleeping ``delay_secs`` — so tests can hold a commit in flight."""
        def hook(tmp_dir, name):
            if name == at_file:
                self.log.append((name, "delayed_commit"))
                if gate is not None:
                    gate.wait(timeout=60)
                elif delay_secs:
                    time.sleep(delay_secs)

        prev = ckpt_writer._file_written_hook
        ckpt_writer._file_written_hook = hook
        try:
            yield self
        finally:
            ckpt_writer._file_written_hook = prev

    @contextlib.contextmanager
    def crash_mid_save(self, at_file=ckpt_const.MODEL_STATES_NPZ):
        """While active, the atomic writer dies after writing ``at_file``
        (leaving a torn tmp dir the commit protocol must never promote)."""
        def hook(tmp_dir, name):
            if name == at_file:
                self.log.append((name, "crash_mid_save"))
                raise OSError("chaos: simulated crash mid-save")

        prev = ckpt_writer._file_written_hook
        ckpt_writer._file_written_hook = hook
        try:
            yield self
        finally:
            ckpt_writer._file_written_hook = prev
