"""CheckpointManager: async commits, retention, retry, preemption drain
(port of ``deepspeed_tpu/checkpoint/manager.py``).

One manager per engine.  ``save()`` takes an already-captured
:class:`~deepspeed_tpu_torch.checkpoint.snapshot.CheckpointSnapshot` and either
commits it inline (sync) or on a background thread (async) so
``train_batch`` resumes immediately after the host gather.  Commits to the
same directory serialize on a per-directory lock, and every in-flight
async save is tracked in a module-level registry so loaders (including a
different engine in the same process) can :func:`drain_inflight` before
resolving ``latest``.

Writer threads are non-daemon on purpose: a normal interpreter exit waits
for the last commit instead of tearing a checkpoint.  A writer thread
handles host numpy arrays only, never a CUDA tensor.  The training
engine sets the ``telemetry`` hook to its
:class:`~deepspeed_tpu_torch.telemetry.manager.TelemetryManager`.
"""

import logging
import os
import shutil
import signal
import threading
import time
import weakref

from ..resilience.constants import EXIT_STEP_HANG
from . import writer
from .constants import META_JSON, OLD_SUFFIX, TMP_SUFFIX

logger = logging.getLogger(__name__)

# RLocks throughout: the preemption handler runs ON the main thread and
# may interrupt a sync commit that already holds the dir/registry lock —
# a plain Lock would deadlock the final save
_REGISTRY_LOCK = threading.RLock()
_INFLIGHT = {}    # realpath(save_dir) -> [Thread, ...]
_DIR_LOCKS = {}   # realpath(save_dir) -> RLock (commit serialization)
# module-global like the locks: the monotonic-`latest` guard must hold
# across every manager/engine in the process writing the same dir
_COMMITTED_STEPS = {}   # realpath(save_dir) -> newest committed step

# monotonic deadline set while the preemption handler runs: commits must
# not block indefinitely on a dir lock a hung writer thread still holds
_PREEMPT_DEADLINE = None


def _dir_key(save_dir):
    return os.path.realpath(str(save_dir))


def _dir_lock(save_dir):
    with _REGISTRY_LOCK:
        return _DIR_LOCKS.setdefault(_dir_key(save_dir), threading.RLock())


# preemption-handler state: one OS-level handler per process; callbacks
# are weakrefs for bound methods (dead engines drop out) or thunks for
# plain functions
_PREEMPT_CALLBACKS = []   # [ref()] -> final_save_fn or None when dead
_PREEMPT_PREVIOUS = {}    # signum -> disposition we replaced


def _arm_drain_watchdog(grace):
    """Hard deadline on the WHOLE preemption drain + final save.

    The lock acquires below are individually bounded, but the final
    save's actual payload write is not — stuck storage (a wedged NFS
    mount, a dead remote filesystem) can pin ``fn()`` mid-``write()``
    far past every lock timeout.  Without this, the process sits in the
    hung syscall until the launcher's SIGKILL at the END of the full
    kill grace, and the exit reads as an unhandled signal death.  The
    watchdog turns that into a deliberate, RESPAWNABLE hang exit
    (:data:`EXIT_STEP_HANG`): the
    supervisor reads lost capacity and respawns/resizes immediately
    instead of waiting out the grace.

    Deadline: ``DS_TERM_DRAIN_DEADLINE_SECS`` (<= 0 disables), default
    90% of the kill grace — inside the window the launcher would have
    SIGKILLed us anyway, so arming it never loses a save that would
    have landed.  Returns the armed timer (cancel on normal handler
    completion), or None when disabled."""
    raw = os.environ.get("DS_TERM_DRAIN_DEADLINE_SECS", "")
    try:
        secs = float(raw) if raw else grace * 0.9
    except ValueError:
        # this runs INSIDE the SIGTERM handler: a malformed env value
        # must degrade to the default, never abort the drain + final
        # save it exists to protect
        logger.warning(
            f"DS_TERM_DRAIN_DEADLINE_SECS={raw!r} is not a number; "
            f"using the default (90% of the kill grace)")
        secs = grace * 0.9
    if secs <= 0:
        return None

    def fire():
        logger.error(
            f"preemption drain still running at the hard deadline "
            f"({secs:.1f}s): the checkpoint writer itself is hung; "
            f"exiting {EXIT_STEP_HANG} (respawnable) instead of pinning "
            "the process until the launcher's SIGKILL")
        os._exit(EXIT_STEP_HANG)

    timer = threading.Timer(secs, fire)
    timer.daemon = True
    timer.start()
    return timer


def _preemption_handler(signum, frame):
    global _PREEMPT_DEADLINE
    logger.warning(f"signal {signum}: draining checkpoint writes and "
                   "taking a final synchronous checkpoint")
    _PREEMPT_CALLBACKS[:] = [r for r in _PREEMPT_CALLBACKS
                             if r() is not None]
    # bounded drain: a writer queued on a dir RLock the interrupted main
    # thread owns can never finish while we join it — time-box to a slice
    # of the launcher's kill grace and let the final save (which CAN
    # re-enter that RLock) use the rest
    try:
        grace = float(os.environ.get("DS_TERM_GRACE_SECS", "30"))
    except ValueError:
        # inside the SIGTERM handler: a malformed env value must never
        # abort the drain + final save (same contract as the drain
        # watchdog's own env parse below)
        logger.warning(
            f"DS_TERM_GRACE_SECS="
            f"{os.environ.get('DS_TERM_GRACE_SECS')!r} is not a "
            f"number; using 30")
        grace = 30.0
    drain_watchdog = _arm_drain_watchdog(grace)
    try:
        if not drain_inflight(timeout=grace / 3):
            logger.warning("preemption drain timed out; proceeding to the "
                           "final synchronous checkpoint")
    except Exception as e:  # noqa: BLE001 — dying anyway; say why
        logger.error(f"preemption drain failed: {e}")
    # a writer that survived the drain may still HOLD a dir lock (stuck
    # storage); bound the final save's lock acquire so it skips with an
    # error instead of pinning the process until the launcher's SIGKILL
    _PREEMPT_DEADLINE = time.monotonic() + grace / 2
    try:
        for ref in reversed(_PREEMPT_CALLBACKS):  # newest engine first
            fn = ref()
            if fn is None:
                continue
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — dying anyway; say why
                logger.error(f"preemption checkpoint failed: {e}")
    finally:
        _PREEMPT_DEADLINE = None
        if drain_watchdog is not None:
            drain_watchdog.cancel()
    prev = _PREEMPT_PREVIOUS.get(signum)
    if callable(prev):
        prev(signum, frame)
    else:
        # SIG_DFL/SIG_IGN, or None (installed outside python): restore
        # and re-deliver so shutdown proceeds under that disposition
        signal.signal(signum, signal.SIG_DFL if prev is None else prev)
        signal.raise_signal(signum)


def drain_inflight(save_dir=None, timeout=None):
    """Join pending async saves (for ``save_dir``, or all).  Returns True
    if everything drained within ``timeout``."""
    with _REGISTRY_LOCK:
        if save_dir is None:
            threads = [t for ts in _INFLIGHT.values() for t in ts]
        else:
            threads = list(_INFLIGHT.get(_dir_key(save_dir), ()))
    deadline = None if timeout is None else time.monotonic() + timeout
    for t in threads:
        t.join(None if deadline is None
               else max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            return False
    return True


class CheckpointManager:
    """Owns the write side of the checkpoint subsystem for one engine."""

    def __init__(self, config=None):
        from .config import DeepSpeedCheckpointConfig

        self.config = config or DeepSpeedCheckpointConfig({})
        self.last_error = None            # last failed commit's exception
        self._errors = {}                 # dir key -> last failed commit
        # optional TelemetryManager (engine-injected; this module never
        # imports telemetry): checkpoint lifecycle events — queue depth,
        # commit latency/bytes/retries, failures — emitted from the save
        # path and the background writer threads
        self.telemetry = None

    def _emit(self, event_type, step=None, **data):
        if self.telemetry is not None:
            self.telemetry.emit(event_type, step=step, **data)

    # ------------------------------------------------------------- save
    def save(self, snapshot, save_dir, async_save=None):
        """Commit ``snapshot`` under ``save_dir``; returns True if the
        commit succeeded (async saves return True optimistically — check
        ``last_error`` / ``wait()`` for the outcome)."""
        if async_save is None:
            async_save = self.config.async_save
        prior = self._errors.get(_dir_key(save_dir))
        if prior is not None:
            # async failures are otherwise only visible via wait(): keep
            # shouting on every subsequent save so a disk-full job cannot
            # run to completion having silently written zero checkpoints
            logger.error(f"previous checkpoint save to {save_dir} FAILED "
                         f"({prior}); call engine.wait_checkpoint() to "
                         "turn async saves into a durable guarantee")
        if not async_save:
            return self._commit(snapshot, save_dir)

        key = _dir_key(save_dir)
        thread = threading.Thread(
            target=self._commit_tracked, args=(snapshot, save_dir),
            name=f"ckpt-writer-{snapshot.tag}", daemon=False)
        # register + start under one lock so drain_inflight can never
        # snapshot (and try to join) a not-yet-started thread
        with _REGISTRY_LOCK:
            _INFLIGHT.setdefault(key, []).append(thread)
            depth = len(_INFLIGHT[key])
            try:
                thread.start()
            except Exception:
                _INFLIGHT[key].remove(thread)
                raise
        self._emit("ckpt_queued", step=snapshot.global_steps,
                   tag=str(snapshot.tag), queue_depth=depth)
        if self.telemetry is not None:
            self.telemetry.gauge("ckpt/queue_depth").set(depth)
        return True

    def wait(self, save_dir=None, timeout=None):
        """Drain this process's pending async saves; raise if the most
        recent commit for ``save_dir`` (or, with no dir, for any dir this
        manager saved to) failed."""
        ok = drain_inflight(save_dir, timeout)
        if save_dir is None:
            errors = list(self._errors.values())
        else:
            err = self._errors.get(_dir_key(save_dir))
            errors = [err] if err is not None else []
        if errors:
            raise writer.CheckpointError(
                f"async checkpoint save failed: {errors[-1]}"
            ) from errors[-1]
        return ok

    def _commit_tracked(self, snapshot, save_dir):
        try:
            self._commit(snapshot, save_dir)
        finally:
            with _REGISTRY_LOCK:
                threads = _INFLIGHT.get(_dir_key(save_dir), [])
                threads[:] = [t for t in threads
                              if t is not threading.current_thread()]
                depth = len(threads)
            if self.telemetry is not None:
                # drain side of the queue-depth gauge: without this the
                # last enqueue's depth sticks in every later snapshot and
                # reads as a permanently stuck writer
                self.telemetry.gauge("ckpt/queue_depth").set(depth)

    def _commit(self, snapshot, save_dir):
        lock = _dir_lock(save_dir)
        deadline = _PREEMPT_DEADLINE
        if deadline is not None:
            # preemption final save: never block past the kill grace on a
            # lock a hung writer thread may hold (reentrant main-thread
            # acquisition still succeeds instantly)
            if not lock.acquire(timeout=max(0.0,
                                            deadline - time.monotonic())):
                e = writer.CheckpointError(
                    f"checkpoint {snapshot.tag} skipped: dir lock for "
                    f"{save_dir} still held at the preemption deadline")
                self.last_error = e
                self._errors[_dir_key(save_dir)] = e
                logger.error(str(e))
                return False
        else:
            lock.acquire()
        try:
            return self._commit_locked(snapshot, save_dir)
        finally:
            lock.release()

    def _commit_locked(self, snapshot, save_dir):
        attempts = self.config.save_retries + 1
        final_dir = None
        t_commit0 = time.monotonic()
        retries_used = 0
        for attempt in range(attempts):
            try:
                final_dir = writer.write_checkpoint(
                    save_dir, snapshot.tag, snapshot.file_writers(),
                    extra_manifest=snapshot.manifest_extra())
                retries_used = attempt
                break
            except Exception as e:  # noqa: BLE001 — retry any I/O error
                if attempt + 1 >= attempts:
                    self.last_error = e
                    self._errors[_dir_key(save_dir)] = e
                    logger.error(
                        f"checkpoint {snapshot.tag} failed after "
                        f"{attempts} attempt(s): {e}")
                    self._commit_failed_telemetry(snapshot, e)
                    return False
                backoff = self.config.retry_backoff_secs * (2 ** attempt)
                logger.warning(
                    f"checkpoint {snapshot.tag} attempt "
                    f"{attempt + 1}/{attempts} failed ({e}); retrying "
                    f"in {backoff:.1f}s")
                time.sleep(backoff)

        key = _dir_key(save_dir)
        step = snapshot.global_steps
        try:
            if writer.read_latest(save_dir) is None:
                # no `latest` on disk: the dir was wiped or is brand new —
                # a stale guard from a previous run must not pin it
                _COMMITTED_STEPS.pop(key, None)
            # an out-of-order late commit must not move `latest` (or the
            # retention window) backwards past a newer checkpoint
            if snapshot.save_latest and step >= _COMMITTED_STEPS.get(
                    key, -1):
                writer.write_latest(save_dir, snapshot.tag)
        except Exception as e:  # noqa: BLE001 — surface via wait()
            self.last_error = e
            self._errors[key] = e
            logger.error(f"checkpoint {snapshot.tag} committed but "
                         f"'latest' pointer update failed: {e}")
            self._commit_failed_telemetry(snapshot, e)
            return False
        if snapshot.save_latest:
            # save_latest=False commits (archival tags) must not pin the
            # guard: a later lower-step save that DOES want `latest` moved
            # would otherwise be silently skipped
            _COMMITTED_STEPS[key] = max(step, _COMMITTED_STEPS.get(key, -1))
        self._errors.pop(key, None)
        self.last_error = None
        try:
            self._apply_retention(save_dir)
        except Exception as e:  # noqa: BLE001 — the save itself landed
            logger.warning(f"retention sweep after {snapshot.tag} "
                           f"failed (checkpoint is committed): {e}")
        self._commit_ok_telemetry(snapshot, final_dir,
                                  time.monotonic() - t_commit0,
                                  retries_used)
        logger.info(f"saved checkpoint {final_dir}")
        return True

    # --------------------------------------------------------- telemetry
    def _commit_ok_telemetry(self, snapshot, final_dir, latency_secs,
                             retries):
        if self.telemetry is None:
            return
        total_bytes = 0
        try:
            manifest = writer.read_manifest(final_dir)
            if manifest:
                total_bytes = sum(
                    int(e.get("bytes", 0))
                    for e in manifest.get("files", {}).values())
        except (OSError, ValueError) as e:
            logger.warning("telemetry: unreadable manifest under "
                           f"{final_dir}: {e}")
        self._emit("ckpt_commit", step=snapshot.global_steps,
                   tag=str(snapshot.tag), latency_secs=float(latency_secs),
                   bytes=total_bytes, retries=int(retries))
        self.telemetry.counter("ckpt/commits").inc()
        self.telemetry.counter("ckpt/bytes_written").inc(total_bytes)
        if retries:
            self.telemetry.counter("ckpt/retries").inc(retries)
        self.telemetry.histogram("ckpt/commit_latency_secs").observe(
            latency_secs)

    def _commit_failed_telemetry(self, snapshot, error):
        if self.telemetry is None:
            return
        self._emit("ckpt_failed", step=snapshot.global_steps,
                   tag=str(snapshot.tag), error=str(error))
        self.telemetry.counter("ckpt/failures").inc()

    # -------------------------------------------------------- retention
    def _list_committed(self, save_dir):
        """[(step, tag)] for every committed checkpoint dir under
        ``save_dir`` (manifest step, falling back to meta.json, then -1)."""
        out = []
        try:
            names = os.listdir(save_dir)
        except OSError:
            return out
        for name in names:
            path = os.path.join(save_dir, name)
            if (not os.path.isdir(path) or name.endswith(TMP_SUFFIX)
                    or name.endswith(OLD_SUFFIX)):
                continue
            step = None
            try:
                manifest = writer.read_manifest(path)
                if manifest is not None:
                    step = manifest.get("global_steps")
                elif os.path.isfile(os.path.join(path, META_JSON)):
                    import json

                    with open(os.path.join(path, META_JSON)) as f:
                        step = json.load(f).get("global_steps")
                else:
                    continue  # not a checkpoint dir; never touch it
            except (OSError, ValueError):
                continue
            out.append((int(step) if step is not None else -1, name))
        return out

    def _apply_retention(self, save_dir):
        """Prune committed checkpoints down to the configured policy and
        sweep stale ``*.tmp`` dirs.  Runs under the dir lock right after a
        successful commit, so any tmp dir present is a dead write."""
        for name in os.listdir(save_dir):
            path = os.path.join(save_dir, name)
            if name.endswith(TMP_SUFFIX):
                (shutil.rmtree if os.path.isdir(path) else os.remove)(path)
            elif name.endswith(OLD_SUFFIX) and os.path.isdir(path):
                # parked-aside dir from a same-tag re-save: recover it if
                # its final dir is gone (interrupted re-save), else it is
                # superseded and dead
                tag = name[:-len(OLD_SUFFIX)]
                if not writer.recover_tag(save_dir, tag):
                    shutil.rmtree(path, ignore_errors=True)

        n = self.config.keep_last_n
        if n <= 0:
            return
        committed = sorted(self._list_committed(save_dir))
        latest_tag = writer.read_latest(save_dir)
        every = self.config.keep_every_n_steps
        keep = {tag for _, tag in committed[-n:]}
        if latest_tag:
            keep.add(latest_tag)
        if every > 0:
            keep.update(tag for step, tag in committed
                        if step >= 0 and step % every == 0)
        for _, tag in committed:
            if tag not in keep:
                shutil.rmtree(os.path.join(save_dir, tag),
                              ignore_errors=True)
                logger.info(f"retention: pruned checkpoint {tag}")

    # ------------------------------------------------------- preemption
    def install_preemption_handler(self, final_save_fn,
                                   signals=(signal.SIGTERM,)):
        """On SIGTERM (a preemption notice), drain in-flight saves, run
        one final SYNCHRONOUS ``final_save_fn()``, then re-deliver the
        signal to the previous disposition so shutdown proceeds.  Only
        callable from the main thread; chained handlers are preserved.

        One OS-level handler is installed per process no matter how many
        engines register: callbacks go into a module-level list, bound
        methods as weakrefs so a discarded engine neither leaks nor gets
        a pointless final checkpoint on preemption."""
        if threading.current_thread() is not threading.main_thread():
            logger.warning("preemption handler not installed: signal "
                           "handlers require the main thread")
            return False

        try:
            ref = weakref.WeakMethod(final_save_fn)
        except TypeError:  # plain function/lambda: hold it strongly
            ref = (lambda f=final_save_fn: f)
        _PREEMPT_CALLBACKS.append(ref)

        for sig in signals:
            # (re)install only if something else holds the disposition —
            # installing our own handler over itself would self-chain
            current = signal.getsignal(sig)
            if current is not _preemption_handler:
                _PREEMPT_PREVIOUS[sig] = current
                signal.signal(sig, _preemption_handler)
        return True
