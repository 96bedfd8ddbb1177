"""The rank functions of the port's pipeline tests (jax-free: the spawned
gloo ranks import neither jax nor the JAX package).

The layers, data and configs mirror the JAX package's
``tests/unit/test_pipe.py`` (a tanh Linear stack, the GPT-like stack with
an embedding tied to its LM head by ``tied_weight_attr``, a tuple
boundary), in torch; the parent test draws the weights with the JAX
module, carries them over as numpy trees, and holds what the ranks
return against the JAX ``PipelineEngine``.  One function runs every case
of one world size, so each world is spawned once.
"""

import numpy as np
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel import PIPE_AXIS, make_mesh
from deepspeed_tpu_torch.runtime.pipe import engine as pipe_engine
from deepspeed_tpu_torch.runtime.pipe import (LayerSpec, PipelineModule,
                                              TiedLayerSpec)

HIDDEN = 16
VOCAB = 32
MICRO_BATCHES = 4
MB_SIZE = 8
STEPS = 5
# clipping that binds (the tiny stacks' gradient norm is ~0.035) under an
# Adam eps large enough that the update feels the gradient's scale
# (Adam's update is otherwise blind to a uniform clip)
CLIP_ADAM = {"type": "Adam", "params": {"lr": 1e-2, "eps": 1e-3}}
CLIP = 0.01
# the 16-bit cases (the GPT-like stack computes in the params' dtype in
# both packages)
HALF = {"bf16": {"bf16": {"enabled": True}},
        "fp16": {"fp16": {"enabled": True, "initial_scale_power": 8}}}


class Linear:
    seq_parallel = True   # per position

    def __init__(self, in_dim, out_dim, act=True):
        self.in_dim, self.out_dim, self.act = in_dim, out_dim, act

    def init(self, seed):
        rng = np.random.default_rng(seed)
        return {"w": (rng.standard_normal((self.in_dim, self.out_dim))
                      * 0.1).astype(np.float32),
                "b": np.zeros((self.out_dim,), np.float32)}

    def apply(self, params, x):
        # in the params' dtype (fp16 under the fp16 engine)
        y = x.to(params["w"].dtype) @ params["w"] + params["b"]
        return torch.tanh(y) if self.act else y


class Embed:
    """Embedding with a per-use bias: the table is tied, the bias not."""

    seq_parallel = True   # per position

    def __init__(self, vocab, hidden):
        self.vocab, self.hidden = vocab, hidden

    def init(self, seed):
        rng = np.random.default_rng(seed)
        return {"table": (rng.standard_normal((self.vocab, self.hidden))
                          * 0.1).astype(np.float32),
                "bias": np.zeros((self.hidden,), np.float32)}

    def apply(self, params, x):
        return params["table"][x] + params["bias"]


def lm_head(params, x):
    return x @ params["table"].T + params["bias"][:1][0]


lm_head.seq_parallel = True   # per position


class SplitCarry:
    """A layer whose output is a (hidden, counter) tuple."""

    def init(self, seed):
        return {"w": np.eye(HIDDEN, dtype=np.float32)}

    def apply(self, params, x):
        if isinstance(x, tuple):
            a, b = x
            return (torch.tanh(a @ params["w"]), b + 1.0)
        return (torch.tanh(x @ params["w"]), torch.zeros(x.shape[:1]))


class MergeCarry:
    def init(self, seed):
        return {"w": np.eye(HIDDEN, dtype=np.float32)}

    def apply(self, params, x):
        a, b = x
        return a @ params["w"] + b[:, None]


def mse_loss(outputs, labels):
    return torch.mean((outputs - labels) ** 2)


def xent_loss(logits, labels):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def linear_specs(n=8):
    return [LayerSpec(Linear, HIDDEN, HIDDEN) for _ in range(n)]


def gpt_like_specs(n_blocks=8):
    return ([TiedLayerSpec("emb", Embed, VOCAB, HIDDEN,
                           tied_weight_attr="table")]
            + [LayerSpec(Linear, HIDDEN, HIDDEN) for _ in range(n_blocks)]
            + [TiedLayerSpec("emb", Embed, VOCAB, HIDDEN, forward_fn=lm_head,
                             tied_weight_attr="table")])


def carry_specs():
    return [LayerSpec(SplitCarry), LayerSpec(SplitCarry),
            LayerSpec(SplitCarry), LayerSpec(MergeCarry)]


def ragged_specs():
    """Boundaries of 16, 8 and 16 features at four stages: not uniform."""
    return [LayerSpec(Linear, HIDDEN, HIDDEN), LayerSpec(Linear, HIDDEN, 8),
            LayerSpec(Linear, 8, HIDDEN), LayerSpec(Linear, HIDDEN, HIDDEN)]


def linear_data(micro_batches=MICRO_BATCHES, mb_size=MB_SIZE, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(mb_size, HIDDEN)).astype(np.float32),
             rng.normal(size=(mb_size, HIDDEN)).astype(np.float32))
            for _ in range(micro_batches)]


def token_data(micro_batches=MICRO_BATCHES, mb_size=MB_SIZE, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, size=(mb_size, 4)).astype(np.int32),
             rng.integers(0, VOCAB, size=(mb_size, 4)).astype(np.int32))
            for _ in range(micro_batches)]


def config(dp=1, micro_batches=MICRO_BATCHES, mb_size=MB_SIZE, **extra):
    cfg = {"train_micro_batch_size_per_gpu": mb_size // dp,
           "gradient_accumulation_steps": micro_batches,
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    cfg.update(extra)
    return cfg


def rows(data, dp_rank, dp):
    """This data rank's rows of every micro-batch."""
    per = data[0][0].shape[0] // dp
    return [(x[dp_rank * per:(dp_rank + 1) * per],
             y[dp_rank * per:(dp_rank + 1) * per]) for x, y in data]


def engine(specs, params, cfg, mesh, loss=mse_loss, **module_kw):
    module = PipelineModule(specs, loss_fn=loss, **module_kw)
    eng, *_ = tds.initialize(model=module, model_parameters=params,
                             config=cfg, mesh=mesh, device="cpu")
    return eng


def train(eng, data, steps=STEPS):
    mine = rows(data, eng.dp_rank, eng.dp_world_size)
    return [float(eng.train_batch(iter(mine))) for _ in range(steps)]


def stage_state(eng):
    """The stage's unpadded master and what the executor logged."""
    return {"master": eng.flat.gather_master_unpadded(eng.master),
            "flat_params": int(sum(eng.segments.sizes)),
            "layers": list(eng.stage_layers),
            "executed": [[repr(c) for c in s] for s in eng.executed],
            "trace": [[repr(c) for c in s]
                      for s in eng.schedule_trace(eng.stage_id)],
            "max_live": eng.max_live_buffers,
            "buffers": eng._schedule("train", eng.micro_batches,
                                     eng.stage_id).num_pipe_buffers()}


def metadata_per_batch(eng, data):
    """One more ``train_batch``: the activation metadata tensors this
    rank encoded and decoded in it, and its point-to-point sends."""
    counts = {"encoded": 0, "decoded": 0}
    encode, decode = pipe_engine._encode_meta, pipe_engine._decode_meta

    def counted(fn, key):
        def call(*args):
            counts[key] += 1
            return fn(*args)
        return call

    pipe_engine._encode_meta = counted(encode, "encoded")
    pipe_engine._decode_meta = counted(decode, "decoded")
    comm.counter.reset()
    try:
        train(eng, data, 1)
    finally:
        pipe_engine._encode_meta, pipe_engine._decode_meta = encode, decode
    return {**counts, "sends": comm.counter.calls["send"]}


def ppermute_ring(rank, world, seed):
    """``ppermute`` one step round the pipe axis, forward and back, and a
    permutation that leaves a member out (it receives zeros)."""
    mesh = make_mesh({PIPE_AXIS: world})
    x = torch.tensor([10.0 * rank, 10.0 * rank + 1])
    fwd = comm.ppermute(x, PIPE_AXIS, [(i, (i + 1) % world)
                                       for i in range(world)], mesh=mesh)
    back = comm.ppermute(fwd, PIPE_AXIS, [((i + 1) % world, i)
                                          for i in range(world)], mesh=mesh)
    partial = comm.ppermute(x, PIPE_AXIS, [(0, 1)], mesh=mesh)
    sends = comm.counter.calls["send"]
    # the ring attention's rotation: one step round the seq axis, posted
    # asynchronously and waited for after
    seq = make_mesh({"seq": world})
    got = torch.empty_like(x)
    handle = comm.send_recv(sends=[(x, (rank + 1) % world)],
                            recvs=[(got, (rank - 1) % world)],
                            axis_name="seq", mesh=seq, async_op=True)
    handle.wait()
    return {"fwd": fwd.numpy(), "back": back.numpy(),
            "partial": partial.numpy(), "sends": sends,
            "seq_shift": got.numpy()}


def pipe2_world(rank, world, seed, lin, gpt, save_dir, jax_dir):
    """Every pipe = 2 case on 2 ranks (see the parent tests)."""
    mesh = make_mesh({PIPE_AXIS: 2})
    lin_data, tok_data = linear_data(), token_data()
    out = {}

    eng = engine(linear_specs(), lin, config(), mesh)
    out["plain"] = {"losses": train(eng, lin_data), **stage_state(eng)}
    out["plain"]["meta"] = metadata_per_batch(eng, lin_data)
    eng = engine(linear_specs(), lin, config(), mesh, interleave=2)
    out["interleave"] = {"losses": train(eng, lin_data),
                         **stage_state(eng)}
    out["interleave"]["meta"] = metadata_per_batch(eng, lin_data)
    for label, kw in (("tied", {}),
                      ("tied_remat", {"activation_checkpoint_interval": 1})):
        eng = engine(gpt_like_specs(), gpt, config(), mesh, loss=xent_loss,
                     partition_method="uniform", **kw)
        out[label] = {"losses": train(eng, tok_data), **stage_state(eng)}
    for label, clip in (("tied_clip", CLIP), ("tied_noclip", 0.0)):
        eng = engine(gpt_like_specs(), gpt,
                     config(gradient_clipping=clip, optimizer=CLIP_ADAM),
                     mesh, loss=xent_loss, partition_method="uniform")
        out[label] = {"losses": train(eng, tok_data), **stage_state(eng),
                      "tied_copy": eng.get_master_params()["tied"]["emb"]
                      .numpy().copy()}
    out["interleave_refused"] = []
    for n_layers, micro_batches in ((8, 3), (3, 4)):
        try:
            engine(linear_specs(n_layers), None,
                   config(micro_batches=micro_batches), mesh, interleave=2)
            out["interleave_refused"].append(None)
        except AssertionError as e:
            out["interleave_refused"].append(str(e))
    out["fp16"] = fp16_overflow(mesh, lin, lin_data)
    for label, extra in HALF.items():
        eng = engine(gpt_like_specs(), gpt, config(**extra), mesh,
                     loss=xent_loss, partition_method="uniform")
        out[f"tied_{label}"] = {"losses": train(eng, tok_data)}
    # save at step 2, then two more steps; then the JAX package's
    # pipe = 4 checkpoint into pipe = 2
    eng = engine(gpt_like_specs(), gpt, config(), mesh, loss=xent_loss,
                 partition_method="uniform")
    train(eng, tok_data, 2)
    eng.save_checkpoint(save_dir, sync=True)
    eng.wait_checkpoint(save_dir)
    out["ckpt"] = {"after": train(eng, tok_data, 2)}
    eng = engine(gpt_like_specs(), gpt, config(), mesh, loss=xent_loss,
                 partition_method="uniform")
    eng.load_checkpoint(jax_dir, strict=True)
    out["from_jax"] = {"after": train(eng, tok_data, 2),
                       "global_steps": eng.global_steps}
    return out


def fp16_overflow(mesh, params, data, poison_step=3, steps=5):
    """fp16 under the dynamic scaler; before step ``poison_step`` an inf
    is written into stage 0's gradient after its last micro-batch, so
    only stage 0 sees the overflow.  Returns the losses, the skip count
    and scale after each step, and whether the step left the master
    unchanged."""
    eng = engine(linear_specs(), params,
                 config(fp16={"enabled": True, "initial_scale_power": 8,
                             "hysteresis": 1}),
                 mesh)
    mine = rows(data, eng.dp_rank, eng.dp_world_size)
    orig = eng._after_backward
    calls = {"n": 0}

    def poisoned():
        calls["n"] += 1
        if eng.global_steps == poison_step - 1 and eng.stage_id == 0 \
                and calls["n"] % eng.micro_batches == 0:
            eng._grad.view(-1)[0] = float("inf")
        orig()

    eng._after_backward = poisoned
    trace = []
    for _ in range(steps):
        before = eng.master.clone()
        loss = float(eng.train_batch(iter(mine)))
        trace.append({"loss": loss, "skipped": eng.skipped_steps,
                      "scale": eng.loss_scale,
                      "unchanged": bool(torch.equal(before, eng.master))})
    return trace


def pipe4_world(rank, world, seed, lin, gpt, carry, port_dir):
    """pipe = 4 and pipe = 2 × data = 2 on 4 ranks (see the parent
    tests)."""
    out = {}
    mesh = make_mesh({PIPE_AXIS: 4})
    lin_data, tok_data = linear_data(), token_data()
    eng = engine(linear_specs(), lin, config(), mesh)
    out["pipe4"] = {"losses": train(eng, lin_data), **stage_state(eng)}
    out["pipe4"]["meta"] = metadata_per_batch(eng, lin_data)
    eng = engine(carry_specs(), carry, config(), mesh)
    out["carry"] = {"losses": train(eng, lin_data, 2)}
    eng = engine(gpt_like_specs(), gpt, config(), mesh, loss=xent_loss,
                 partition_method="uniform")
    eng.load_checkpoint(port_dir, strict=True)
    out["from_pipe2"] = {"after": train(eng, tok_data, 2)}
    try:
        eng = engine(ragged_specs(), None, config(), mesh,
                     partition_method="uniform")
        train(eng, lin_data, 1)
        out["ragged"] = None
    except AssertionError as e:
        out["ragged"] = str(e)
    mesh = make_mesh({PIPE_AXIS: 2, "data": 2})
    zero2 = {"stage": 2}
    eng = engine(linear_specs(), lin, config(2, zero_optimization=zero2),
                 mesh)
    out["pipe2_data2"] = {"losses": train(eng, lin_data),
                          **stage_state(eng)}
    eng = engine(gpt_like_specs(), gpt,
                 config(2, zero_optimization=zero2, gradient_clipping=CLIP,
                        optimizer=CLIP_ADAM),
                 mesh, loss=xent_loss, partition_method="uniform")
    out["pipe2_data2_tied_clip"] = {"losses": train(eng, tok_data),
                                    **stage_state(eng)}
    eng = engine(gpt_like_specs(), gpt,
                 config(2, zero_optimization={"stage": 1},
                        gradient_clipping=CLIP, optimizer=CLIP_ADAM),
                 mesh, loss=xent_loss, partition_method="uniform")
    out["pipe2_data2_zero1_tied_clip"] = {"losses": train(eng, tok_data)}
    return out


def offload_pipe2(rank, world, seed):
    """The linear stack at pipe 2 under ZeRO-2 with and without
    ``cpu_offload``: each run's losses, the stage's master and the host
    master's shape."""
    mesh = make_mesh({PIPE_AXIS: 2})
    out = {}
    for offload in (False, True):
        eng = engine(linear_specs(), None, config(zero_optimization={
            "stage": 2, "cpu_offload": offload}), mesh)
        out[offload] = {"losses": train(eng, linear_data()),
                        "master": eng.flat.gather_master_unpadded(
                            eng.master),
                        "host": (eng.master.device.type,
                                 tuple(eng.master.shape))}
    return out



# ------------------------------------- ZeRO-3 and 1-bit Adam under a pipe
# Adam's eps at 1e-3 (as ``CLIP_ADAM``): the frozen variance of a 3-step
# warmup is ~0.3% of the second moment, which would send the tiny stack
# off in steps of up to lr·m/eps with a small eps
ONEBIT = {"type": "OneBitAdam",
          "params": {"lr": 1e-3, "freeze_step": 3, "eps": 1e-3}}
ONEBIT_STEPS = 6


def counted_train(eng, data, steps):
    """Losses, and each step's collectives by verb (calls, bytes)."""
    mine = rows(data, eng.dp_rank, eng.dp_world_size)
    losses, calls = [], []
    for _ in range(steps):
        comm.counter.reset()
        losses.append(float(eng.train_batch(iter(mine))))
        calls.append((dict(comm.counter.calls), dict(comm.counter.bytes)))
    return losses, calls


def tied_rows(eng):
    """The stage's master rows of each tied copy."""
    return {key: eng.master[r0:r1].numpy().copy()
            for key, (r0, r1) in eng._tied_rows().items()}


def zero3_onebit_world(rank, world, seed, lin, gpt, save_dir):
    """``{pipe: 2, data: 2}``: ZeRO-3 (and ZeRO-2 beside it) on the
    linear stack and on the tied GPT-like stack with a binding clip, a
    ZeRO-3 checkpoint to ``save_dir``; OneBitAdam through
    ``freeze_step`` on the tied stack."""
    mesh = make_mesh({PIPE_AXIS: 2, "data": 2})
    lin_data, tok_data = linear_data(), token_data()
    out = {}
    for stage in (2, 3):
        eng = engine(linear_specs(), lin,
                     config(2, zero_optimization={"stage": stage}), mesh)
        out[f"lin_z{stage}"] = {"losses": train(eng, lin_data),
                                "master": stage_state(eng)["master"]}
        eng = engine(gpt_like_specs(), gpt,
                     config(2, zero_optimization={"stage": stage},
                            gradient_clipping=CLIP, optimizer=CLIP_ADAM),
                     mesh, loss=xent_loss, partition_method="uniform")
        out[f"tied_z{stage}"] = {"losses": train(eng, tok_data),
                                 "master": stage_state(eng)["master"],
                                 "defer": eng._defer_exchange()}
        if stage == 3:
            # between steps no compute params are held
            out["tied_z3"]["compute_bytes"] = \
                eng._compute.untyped_storage().nbytes()
            out["tied_z3"]["shard_rows"] = int(eng.master.shape[0])
            out["tied_z3"]["stage_rows"] = int(eng.flat.flat_shape[0])
            eng.save_checkpoint(save_dir, sync=True)
            eng.wait_checkpoint(save_dir)
            out["tied_z3"]["eval"] = float(eng.eval_batch(
                iter(rows(tok_data, eng.dp_rank, 2))))
    eng = engine(gpt_like_specs(), gpt,
                 config(2, zero_optimization={"stage": 0}, optimizer=ONEBIT),
                 mesh, loss=xent_loss, partition_method="uniform")
    losses, calls = counted_train(eng, tok_data, ONEBIT_STEPS)
    st = eng.opt_state
    out["onebit"] = {"losses": losses, "calls": calls,
                     "tied": tied_rows(eng),
                     "master": eng.master.numpy().copy(),
                     "n_local": eng.master.numel(),
                     "errors": (tuple(st.worker_error.shape),
                                tuple(st.server_error.shape))}
    return out
