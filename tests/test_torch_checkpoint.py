"""Checkpoints move between the JAX package and the port, both ways.

Tiny GPT-2 (``TINY``: 2 layers, hidden 64, vocab 256, seq 32) and a
2-layer narrow BERT (``BERT_TINY``) train on both engines from numpy
samples made from a seed, through ``initialize(training_data=...)``
under a WarmupLR schedule, so the data cursor and the LR state matter.
The JAX engine runs on ``make_mesh({"data": 1})`` (or 2).  A checkpoint
either package writes loads into the other with the master, both
moments and the step BITWISE equal to the writer's live state (the
format is the same files), the counters, LR state and data cursor
equal; losses across packages after a resume agree at rtol 1e-5 (fp32,
dropout 0: the engines agree to about 2e-7, as in
``test_torch_engine.py``); a resume inside the port is bitwise, dropout
0.1 included.
"""

import contextlib
import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu import checkpoint as jckpt
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.models.bert import BertConfig as JBert
from deepspeed_tpu.models.bert import BertForPreTrainingTPU
from deepspeed_tpu.parallel import make_mesh
from deepspeed_tpu.runtime.utils import tree_path_key
from deepspeed_tpu_torch import checkpoint as tckpt
from deepspeed_tpu_torch.models.bert import BertConfig as TBert
from deepspeed_tpu_torch.models.bert import BertForPreTraining
from deepspeed_tpu_torch.models.bert import random_params as bert_params
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params

from .test_torch_engine import BERT_TINY, TINY, TRAJ_RTOL, bert_batches

# model, bf16, optimizer, ZeRO stage: each model, dtype, optimizer and
# stage at least once
CASES = [("gpt2", False, "Adam", 0), ("gpt2", True, "Lamb", 2),
         ("bert", False, "Lamb", 2), ("bert", True, "Adam", 0)]
CASE_IDS = ["-".join([m, "bf16" if b else "fp32", o, f"zero{s}"])
            for m, b, o, s in CASES]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def samples(kind, n=24, seed=0):
    """``n`` training samples (one row each) from a numpy seed."""
    if kind == "gpt2":
        rng = np.random.default_rng(seed)
        return [{"input_ids": row} for row in
                rng.integers(0, 256, size=(n, 32)).astype(np.int32)]
    rows = []
    for batch in bert_batches(n // 2, seed=seed):
        rows += [{k: v[r] for k, v in batch.items()} for r in range(2)]
    return rows


def ds_config(bf16, opt, stage, micro=2, dp=1, acc=1):
    return {"train_batch_size": micro * dp * acc,
            "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": acc,
            "steps_per_print": 10 ** 9,
            "optimizer": {"type": opt, "params": {"lr": 3e-3}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0,
                                     "warmup_max_lr": 3e-3,
                                     "warmup_num_steps": 6}},
            "zero_optimization": {"stage": stage},
            "bf16": {"enabled": bf16}}


def init_params(kind, seed):
    if kind == "gpt2":
        return random_params(GPT2Config(**TINY), seed=seed)
    return bert_params(TBert(**BERT_TINY), seed=seed)


def jax_engine(kind, config, seed=0, dp=1, data=None):
    mesh = make_mesh({"data": dp}, devices=jax.devices("cpu")[:dp])
    model = (GPT2LMHeadTPU(JConfig(**TINY)) if kind == "gpt2"
             else BertForPreTrainingTPU(JBert(**BERT_TINY)))
    engine, *_ = jds.initialize(
        model=model, model_parameters=jax.tree_util.tree_map(
            jax.numpy.asarray, init_params(kind, seed)),
        config=dict(config), mesh=mesh, training_data=data)
    return engine


def torch_engine(kind, config, seed=0, data=None, model_config=None):
    model = (GPT2LMHead(GPT2Config(**(model_config or TINY)))
             if kind == "gpt2" else BertForPreTraining(TBert(**BERT_TINY)))
    engine, *_ = tds.initialize(model=model,
                                model_parameters=init_params(kind, seed),
                                config=dict(config), device="cpu",
                                training_data=data)
    return engine


def jax_state(engine):
    """The JAX engine's master, moments (unpadded) and step."""
    flat, opt = engine.flat, engine.state["opt"]
    return (flat.gather_master_unpadded(engine.state["master"]),
            flat.gather_master_unpadded(opt.exp_avg),
            flat.gather_master_unpadded(opt.exp_avg_sq), int(opt.step))


def torch_state(engine):
    flat, opt = engine.flat, engine.opt_state
    return (flat.gather_master_unpadded(engine.master),
            flat.gather_master_unpadded(opt.exp_avg),
            flat.gather_master_unpadded(opt.exp_avg_sq), opt.step)


def assert_same_state(a, b):
    for x, y, name in zip(a, b, ("master", "exp_avg", "exp_avg_sq")):
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a[3] == b[3]


def counters(engine):
    return (engine.global_steps, engine.micro_steps, engine.global_samples)


def words(t):
    """The bits of a model-state leaf from either package's loader."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind,bf16,opt,stage", CASES, ids=CASE_IDS)
def test_checkpoint_crosses_packages(tmp_path, direction, kind, bf16, opt,
                                     stage):
    """The writer trains 3 steps and saves; the reader, built from other
    weights, loads: master, moments and step bitwise equal, the model
    states it resumes bitwise the saved ones, counters and LR state
    equal; then one more step on each: the same data cursor (and, in
    fp32, the same loss to 1e-5)."""
    config = ds_config(bf16, opt, stage)
    data = samples(kind)
    jeng = jax_engine(kind, config, seed=0 if direction == "jax_to_port"
                      else 9, data=data)
    teng = torch_engine(kind, config, seed=0 if direction == "port_to_jax"
                        else 9, data=data)
    writer, reader = ((jeng, teng) if direction == "jax_to_port"
                      else (teng, jeng))
    for _ in range(3):
        writer.train_batch()
    if direction == "jax_to_port":
        writer.save_checkpoint(str(tmp_path), sync=True)
    else:
        writer.save_checkpoint(str(tmp_path))   # async, the default
        writer.wait_checkpoint(str(tmp_path))
    path, client = reader.load_checkpoint(str(tmp_path), strict=True)
    assert path.endswith("global_step3") and client is None

    assert_same_state(torch_state(teng), jax_state(jeng))
    assert counters(teng) == counters(jeng) == (3, 3, 6)
    assert teng.lr_scheduler.state_dict() == jeng.lr_scheduler.state_dict()
    np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-7)
    saved = tckpt.load_model_states(path)
    if direction == "jax_to_port":
        resumed = teng._params_to_host()
    else:
        leaves, _ = jax.tree_util.tree_flatten_with_path(jeng.get_params())
        resumed = {tree_path_key(p): np.asarray(v) for p, v in leaves}
    assert set(resumed) == set(saved)
    for key in saved:
        np.testing.assert_array_equal(words(resumed[key]),
                                      words(saved[key]), err_msg=key)

    jloss, tloss = float(jeng.train_batch()), float(teng.train_batch())
    assert (teng.training_dataloader.state_dict()
            == jeng.training_dataloader.state_dict()
            == {"epoch": 1, "samples_yielded": 8})
    if not bf16:
        np.testing.assert_allclose(tloss, jloss, rtol=TRAJ_RTOL, atol=0)


def test_jax_dp2_checkpoint_loads_into_the_port(tmp_path):
    """ZeRO-2 at dp=2 in JAX (the master padded for two ranks) writes;
    the port at dp=1 loads the same global batch (micro 4): the
    unpadded state bitwise, the data cursor, then 5 steps' losses to
    1e-5."""
    data = samples("gpt2", n=40)
    jeng = jax_engine("gpt2", ds_config(False, "Adam", 2, dp=2), dp=2,
                      data=data)
    for _ in range(3):
        jeng.train_batch()
    jeng.save_checkpoint(str(tmp_path), sync=True)
    with open(tmp_path / "global_step3" / "meta.json") as f:
        assert json.load(f)["dp_world_size"] == 2
    teng = torch_engine("gpt2", ds_config(False, "Adam", 2, micro=4),
                        seed=9, data=data)
    teng.load_checkpoint(str(tmp_path), strict=True)
    assert_same_state(torch_state(teng), jax_state(jeng))
    assert counters(teng) == counters(jeng)
    want = [float(jeng.train_batch()) for _ in range(5)]
    got = [float(teng.train_batch()) for _ in range(5)]
    assert (teng.training_dataloader.state_dict()
            == jeng.training_dataloader.state_dict())
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL, atol=0)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_model_states_and_meta_are_the_jax_files(tmp_path, bf16):
    """From the same weights at step 0, both packages write the same
    model-state keys and dtype map, the same meta.json, the same
    optimizer-state keys, shapes and dtypes; bf16 leaves decode to the
    same bits in both packages' loaders, from both packages' files."""
    config = ds_config(bf16, "Lamb", 2)
    data = samples("gpt2")
    jeng = jax_engine("gpt2", config, data=data)
    teng = torch_engine("gpt2", config, data=data)
    jeng.save_checkpoint(str(tmp_path / "jax"), sync=True)
    teng.save_checkpoint(str(tmp_path / "port"), sync=True)
    jdir, tdir = (str(tmp_path / p / "global_step0") for p in ("jax", "port"))

    metas = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "meta.json")) as f:
            metas.append(json.load(f))
    assert metas[0] == metas[1]
    assert bool(metas[0]["model_dtypes"]) == bf16
    for name in ("model_states.npz", "zero_optim_states.npz"):
        with np.load(os.path.join(jdir, name)) as a, \
                np.load(os.path.join(tdir, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
    assert jckpt.read_manifest(jdir)["model_dtypes"] == \
        tckpt.read_manifest(tdir)["model_dtypes"]

    decoded = [loader(d) for d in (jdir, tdir)
               for loader in (jckpt.load_model_states,
                              tckpt.load_model_states)]
    for key in decoded[0]:
        first = words(decoded[0][key])
        for other in decoded[1:]:
            np.testing.assert_array_equal(words(other[key]), first,
                                          err_msg=key)
    if bf16:
        t = decoded[1]["wte"]
        assert t.dtype == torch.bfloat16
        assert decoded[2]["wte"].dtype.name == "bfloat16"


@pytest.mark.parametrize("kind,opt", [("gpt2", "Lamb"), ("bert", "Adam")])
def test_resume_across_packages_matches_jax(tmp_path, kind, opt):
    """JAX trains 3 steps and saves; a fresh JAX engine and the port
    each load it and take 5 steps from their dataloaders (dropout 0):
    the losses agree to 1e-5."""
    config = ds_config(False, opt, 2)
    data = samples(kind)
    writer = jax_engine(kind, config, data=data)
    for _ in range(3):
        writer.train_batch()
    writer.save_checkpoint(str(tmp_path), sync=True)
    del writer
    jeng = jax_engine(kind, config, seed=5, data=data)
    teng = torch_engine(kind, config, seed=6, data=data)
    jeng.load_checkpoint(str(tmp_path), strict=True)
    teng.load_checkpoint(str(tmp_path), strict=True)
    want = [float(jeng.train_batch()) for _ in range(5)]
    got = [float(teng.train_batch()) for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL, atol=0)


DROPOUT_TINY = dict(TINY, embd_dropout=0.1, attn_dropout=0.1,
                    resid_dropout=0.1)


@pytest.mark.parametrize("bf16,opt,stage,acc", [
    (True, "Lamb", 2, 1), (False, "Adam", 0, 2)],
    ids=["bf16-Lamb-zero2", "fp32-Adam-zero0-acc2"])
def test_resume_inside_the_port_is_bitwise(tmp_path, bf16, opt, stage, acc):
    """Train 3 steps, save async, train 3 more; a fresh engine from
    other weights loads and trains 3: losses and master bitwise equal,
    with dropout 0.1 at all three sites (its streams follow the
    restored micro-step count)."""
    config = ds_config(bf16, opt, stage, acc=acc)
    data = samples("gpt2", n=36)
    a = torch_engine("gpt2", config, data=data, model_config=DROPOUT_TINY)
    for _ in range(3):
        a.train_batch()
    a.save_checkpoint(str(tmp_path))
    want = [float(a.train_batch()) for _ in range(3)]
    a.wait_checkpoint(str(tmp_path))
    b = torch_engine("gpt2", config, seed=4, data=data,
                     model_config=DROPOUT_TINY)
    b.load_checkpoint(str(tmp_path), strict=True)
    got = [float(b.train_batch()) for _ in range(3)]
    assert got == want
    assert torch.equal(a.master, b.master)
    assert torch.equal(a.opt_state.exp_avg_sq, b.opt_state.exp_avg_sq)
    assert counters(a) == counters(b)


def test_qres_residuals_fold_as_the_jax_engine_does(tmp_path):
    """A JAX checkpoint from a reduced-precision offload layout carries
    error-feedback residuals under ``qres/<name>``.  Into a layout
    without them (the JAX engine's fp32 state, the port's only one) the
    load folds each into its value: master and moments bitwise as the
    JAX engine loads them."""
    config = ds_config(False, "Adam", 2)
    jeng = jax_engine("gpt2", config)
    batches = samples("gpt2", n=6)
    for i in range(3):
        jeng.train_batch(iter([{"input_ids": np.stack(
            [batches[2 * i]["input_ids"], batches[2 * i + 1]["input_ids"]])}]))
    jeng.save_checkpoint(str(tmp_path / "plain"), sync=True)
    src = tmp_path / "plain" / "global_step3"
    rng = np.random.default_rng(3)
    with np.load(src / "zero_optim_states.npz") as npz:
        optim = {k: npz[k] for k in npz.files}
    for name in ("master", "exp_avg", "exp_avg_sq"):
        optim[f"qres/{name}"] = (rng.standard_normal(optim["master"].shape)
                                 * 1e-4).astype(np.float32)
    payload = {}
    for name in ("model_states.npz", "meta.json"):
        payload[name] = (src / name).read_bytes()
    tckpt.write_checkpoint(
        str(tmp_path / "qres"), "global_step3",
        {"model_states.npz": lambda f: f.write(payload["model_states.npz"]),
         "zero_optim_states.npz": lambda f: np.savez(f, **optim),
         "meta.json": lambda f: f.write(payload["meta.json"])})
    tckpt.write_latest(str(tmp_path / "qres"), "global_step3")

    jload = jax_engine("gpt2", config, seed=8)
    tload = torch_engine("gpt2", config, seed=8)
    jload.load_checkpoint(str(tmp_path / "qres"), strict=True)
    tload.load_checkpoint(str(tmp_path / "qres"), strict=True)
    assert_same_state(torch_state(tload), jax_state(jload))
    master = torch_state(tload)[0]
    np.testing.assert_array_equal(
        master, optim["master"] + optim["qres/master"])



@pytest.mark.parametrize("name,kwargs", [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-3,
                     "lr_range_test_step_size": 7}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 20}),
    ("WarmupLR", {"warmup_num_steps": 30}),
    ("WarmupDecayLR", {"total_num_steps": 80, "warmup_num_steps": 30})])
def test_lr_schedule_state_crosses_packages(name, kwargs):
    """Every schedule's state, saved by one package, loads into the
    other's and re-applies the same LR (and OneCycle's betas) at once."""
    from deepspeed_tpu.runtime import lr_schedules as jls
    from deepspeed_tpu_torch.runtime import lr_schedules as tls

    def groups():
        return type("Groups", (), {"param_groups": [
            {"lr": 0.5, "betas": (0.9, 0.999)}]})()

    for src, dst in ((tls, jls), (jls, tls)):
        ran = src.SCHEDULE_CLASSES[name](groups(), **kwargs)
        for _ in range(25):
            ran.step()
        resumed = dst.SCHEDULE_CLASSES[name](groups(), **kwargs)
        resumed.load_state_dict(json.loads(json.dumps(ran.state_dict())))
        assert resumed.state_dict() == ran.state_dict()
        assert resumed.optimizer.param_groups == ran.optimizer.param_groups

@contextlib.contextmanager
def host_fetches(monkeypatch):
    """Records every call of the Tensor methods that copy to the host
    (each a sync on the card) while the block runs."""
    calls = []
    with monkeypatch.context() as patch:
        for name in ("item", "cpu", "tolist", "numpy", "__float__"):
            original = getattr(torch.Tensor, name)

            def counted(self, *args, _name=name, _original=original, **kw):
                calls.append(_name)
                return _original(self, *args, **kw)

            patch.setattr(torch.Tensor, name, counted)
        yield calls


def test_train_batch_fetches_nothing_from_the_device(tmp_path, monkeypatch):
    """With ``steps_per_print`` above the steps taken, ``train_batch``
    calls no ``Tensor.item``, ``cpu``, ``tolist``, ``numpy`` or
    ``__float__``, with a checkpoint commit in flight or not: saving
    adds nothing to the step path."""
    engine = torch_engine("gpt2", ds_config(True, "Lamb", 2),
                          data=samples("gpt2"), model_config=DROPOUT_TINY)
    engine.train_batch()
    with host_fetches(monkeypatch) as calls:
        for _ in range(2):
            engine.train_batch()
    assert calls == []
    engine.save_checkpoint(str(tmp_path))
    with host_fetches(monkeypatch) as calls:
        engine.train_batch()
    engine.wait_checkpoint(str(tmp_path))
    assert calls == []
    assert tckpt.read_latest(str(tmp_path)) == "global_step3"
    assert tckpt.verify_checkpoint(
        str(tmp_path / "global_step3"))[0] == "ok"
