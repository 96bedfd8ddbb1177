"""Checkpoint file-layout names shared by every writer and reader (copy
of ``deepspeed_tpu/checkpoint/constants.py``: the two packages read and
write the same files).

The on-disk layout::

    <save_dir>/
      latest                    tag of the newest COMMITTED checkpoint
      <tag>/                    a committed checkpoint (atomic os.replace)
        manifest.json           sizes + checksums of every payload file
        model_states.npz        params in NATIVE dtype (dtype map in meta)
        zero_optim_states.npz   unpadded flat master + optimizer leaves
        meta.json               step counters, scale state, dtype map, ...
        client_state.pkl        optional user blob
      <tag>.tmp/                in-progress write; never loadable
"""

MODEL_STATES_NPZ = "model_states.npz"
OPTIM_STATES_NPZ = "zero_optim_states.npz"
META_JSON = "meta.json"
CLIENT_STATE_PKL = "client_state.pkl"
LATEST_FILE = "latest"
MANIFEST_JSON = "manifest.json"
TMP_SUFFIX = ".tmp"
# previous committed dir parked aside during a same-tag re-save; recovered
# (renamed back) on load if a crash hit the one-rename window
OLD_SUFFIX = ".old"
MANIFEST_FORMAT_VERSION = 1
