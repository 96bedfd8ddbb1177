"""The port's serving stack against the JAX package's: config parsing,
the block allocator and scheduler, the prefill/decode forwards (first
tokens and K/V cache contents at fp32 1e-5), and the slice as a whole —
the port's ``InferenceEngine`` and the JAX ``InferenceEngine`` serve the
same staggered stream of seeded requests on the same weights and give
identical tokens, which are also the port's naive reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JConfig
from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import build_decode as jbuild_decode
from deepspeed_tpu.inference import build_prefill as jbuild_prefill
from deepspeed_tpu.inference import init_kv_cache as jinit_kv_cache
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadTPU
from deepspeed_tpu_torch.inference import (
    NULL_BLOCK, BlockAllocator, ContinuousBatchScheduler,
    DeepSpeedInferenceConfig, InferenceEngine, Request, build_decode,
    build_prefill, init_kv_cache, kv_cache_bytes, reference_generate)
from deepspeed_tpu_torch.inference.scheduler import REASON_EOS, \
    REASON_LENGTH
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.module_inject import replace_gpt2_transformer_layer
from deepspeed_tpu_torch.utils.params import params_from_numpy

VOCAB = 256
TINY = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=64, embd_dropout=0.0, attn_dropout=0.0,
            resid_dropout=0.0)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: intra-op threads gain nothing here and
    would only take cores from the tests running beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def serve_config(**inference_overrides):
    inf = {"kv_block_size": 8, "kv_blocks": 64, "max_batch_slots": 4,
           "max_seq_len": 64, "prefill_buckets": [8, 16, 32],
           "token_budget": 256, "max_new_tokens": 8}
    inf.update(inference_overrides)
    return {"inference": inf, "steps_per_print": 4}


def seeded_prompts(n, seed=42, lo=3, hi=30):
    rng = np.random.RandomState(seed)
    return [list(int(t) for t in rng.randint(0, VOCAB,
                                             size=rng.randint(lo, hi)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def models():
    """(jax model, port model, numpy params) on one set of weights."""
    jmodel = GPT2LMHeadTPU(JGPT2Config(**TINY))
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, GPT2LMHead(GPT2Config(**TINY)), params


# ---------------------------------------------------------------- config
CONFIGS = [
    ("defaults", {}, True),
    ("serve", serve_config(), True),
    ("bf16", serve_config(weights_dtype="bfloat16", eos_token_id=3), True),
    ("slo", serve_config(slo={"ttft_ms": 100, "per_token_ms": 50}), True),
    ("max_seq_not_block_multiple", serve_config(max_seq_len=60), False),
    ("bucket_not_block_aligned", serve_config(prefill_buckets=[12]), False),
    ("bucket_beyond_max_seq", serve_config(prefill_buckets=[128]), False),
    ("only_null_block", serve_config(kv_blocks=1), False),
    ("float16_weights", serve_config(weights_dtype="float16"), False),
]


@pytest.mark.parametrize("name,cfg,valid", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_inference_config_parity(name, cfg, valid):
    if not valid:
        with pytest.raises((AssertionError, ValueError)):
            JConfig(cfg)
        with pytest.raises((AssertionError, ValueError)):
            DeepSpeedInferenceConfig(cfg)
        return
    ours, theirs = DeepSpeedInferenceConfig(cfg), JConfig(cfg)
    assert vars(ours) == vars(theirs)
    assert ours.max_blocks_per_seq == theirs.max_blocks_per_seq
    for n in range(1, ours.prefill_buckets[-1] + 1):
        assert ours.bucket_for(n) == theirs.bucket_for(n)
    with pytest.raises(ValueError):
        ours.bucket_for(ours.prefill_buckets[-1] + 1)


# ------------------------------------------------------------- kv blocks
def test_allocator_never_hands_out_null_block():
    alloc = BlockAllocator(8)
    got = alloc.allocate(7)
    assert got is not None and NULL_BLOCK not in got
    assert alloc.free_blocks == 0 and alloc.used_peak == 7


def test_allocator_no_partial_grant_and_recycles():
    alloc = BlockAllocator(4)
    assert alloc.allocate(5) is None
    assert alloc.free_blocks == 3
    got = alloc.allocate(3)
    alloc.release(got)
    assert alloc.free_blocks == 3 and alloc.allocate(3) is not None


def test_kv_cache_shapes_and_bytes():
    k, v = init_kv_cache(2, 5, 8, 4, 16, dtype=torch.bfloat16, device="cpu")
    assert k.shape == v.shape == (2, 5, 8, 4, 16)
    assert k.dtype == torch.bfloat16 and not k.any()
    assert kv_cache_bytes(2, 5, 8, 4, 16, torch.bfloat16) \
        == 2 * k.numel() * 2


# ------------------------------------------------------------- scheduler
def make_scheduler(**overrides):
    icfg = DeepSpeedInferenceConfig(serve_config(**overrides))
    alloc = BlockAllocator(icfg.kv_blocks)
    return ContinuousBatchScheduler(icfg, alloc), alloc


def test_scheduler_rejects_overflow_at_submit():
    sched, _ = make_scheduler(token_budget=32)
    with pytest.raises(ValueError):
        sched.submit(Request("r", list(range(32)), 64))   # > max_seq_len
    with pytest.raises(ValueError):
        sched.submit(Request("r", list(range(40)), 2))    # > largest bucket
    with pytest.raises(ValueError, match="token_budget"):
        sched.submit(Request("r", [1] * 16, 32))          # 48 > budget 32
    assert sched.queue_depth == 0
    sched.submit(Request("ok", [1] * 16, 16))
    assert sched.try_admit().request_id == "ok"


def test_scheduler_fifo_budget_and_slot_recycling():
    sched, alloc = make_scheduler(token_budget=24)
    sched.submit(Request("a", [1] * 10, 8))
    sched.submit(Request("b", [1] * 10, 8))
    a = sched.try_admit()
    assert a.request_id == "a" and sched.try_admit() is None
    free_before = alloc.free_blocks
    sched.finish(a, REASON_LENGTH)
    assert alloc.free_blocks > free_before
    b = sched.try_admit()
    assert b.request_id == "b" and b.slot == a.slot
    row = sched.block_table_row(b)
    assert len(row) == sched.icfg.max_blocks_per_seq
    assert row[:len(b.blocks)] == b.blocks
    assert all(x == NULL_BLOCK for x in row[len(b.blocks):])


def test_scheduler_allocates_worst_case_and_abort_conserves_blocks():
    sched, alloc = make_scheduler()
    sched.submit(Request("r", [1] * 10, 20))
    r = sched.try_admit()
    assert len(r.blocks) == 4       # max(bucket 16, 10 + 20) / 8 blocks
    sched.abort(r)
    assert alloc.free_blocks == alloc.capacity and sched.idle()


# ------------------------------------------------- prefill/decode forwards
def test_prefill_and_decode_match_jax(models):
    """Two requests prefilled into the paged cache, then one decode
    iteration with two live and two parked slots: tokens identical, and
    the whole K/V cache (null block included: the parked slots all write
    the same values there) equal at fp32 1e-5."""
    _, _, params = models
    cfg = serve_config()
    mc, jc = GPT2Config(**TINY), JGPT2Config(**TINY)
    icfg, jicfg = DeepSpeedInferenceConfig(cfg), JConfig(cfg)
    shape = (mc.num_layers, icfg.kv_blocks, icfg.kv_block_size,
             mc.num_heads, mc.hidden_size // mc.num_heads)
    tparams = params_from_numpy(params, "cpu")
    kc, vc = init_kv_cache(*shape, device="cpu")
    jk, jv = jinit_kv_cache(*shape)
    width = icfg.max_blocks_per_seq
    reqs = [(13, 16, [3, 5, 9]), (27, 32, [7, 2, 11, 4, 6])]
    rng = np.random.RandomState(0)
    firsts = []
    for n, bucket, blocks in reqs:
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = rng.randint(0, VOCAB, size=n)
        table = np.array(blocks + [0] * (width - len(blocks)), np.int64)
        tok = build_prefill(mc, icfg, bucket)(
            tparams, kc, vc, torch.from_numpy(ids), n,
            torch.from_numpy(table))
        jtok, jk, jv = jbuild_prefill(jc, jicfg, bucket)(
            params, jk, jv, jnp.asarray(ids, jnp.int32), jnp.int32(n),
            jnp.asarray(table, jnp.int32))
        assert int(tok) == int(jtok)
        firsts.append(int(tok))
    np.testing.assert_allclose(kc.numpy(), np.asarray(jk), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(vc.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)

    tables = np.zeros((icfg.max_batch_slots, width), np.int64)
    ctx_lens = np.zeros((icfg.max_batch_slots,), np.int64)
    tokens = np.zeros((icfg.max_batch_slots,), np.int64)
    for slot, ((n, _, blocks), first) in zip((0, 2), zip(reqs, firsts)):
        tables[slot, :len(blocks)] = blocks
        ctx_lens[slot] = n
        tokens[slot] = first
    nxt = build_decode(mc, icfg)(tparams, kc, vc, torch.from_numpy(tables),
                                 torch.from_numpy(ctx_lens),
                                 torch.from_numpy(tokens))
    jnxt, jk, jv = jbuild_decode(jc, jicfg)(
        params, jk, jv, jnp.asarray(tables, jnp.int32),
        jnp.asarray(ctx_lens, jnp.int32), jnp.asarray(tokens, jnp.int32))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    np.testing.assert_allclose(kc.numpy(), np.asarray(jk), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(vc.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------- engine
def test_engine_token_parity_with_jax_engine(models):
    """The slice as a whole: 8 staggered seeded requests through the
    port's continuous batch give exactly the JAX engine's tokens, and
    the port's naive full-forward reference's."""
    jmodel, model, params = models
    prompts = seeded_prompts(8)

    def serve(engine):
        for i, p in enumerate(prompts[:4]):
            engine.submit(p, max_new_tokens=8, request_id=f"r{i}")
        for _ in range(3):
            engine.step()
        for i, p in enumerate(prompts[4:], start=4):
            engine.submit(p, max_new_tokens=8, request_id=f"r{i}")
        results = engine.run()
        engine.close()
        return results

    ours = serve(InferenceEngine(model, params, config=serve_config(),
                                 device="cpu"))
    theirs = serve(JEngine(jmodel, params, config=serve_config()))
    tparams = params_from_numpy(params, "cpu")
    for i, p in enumerate(prompts):
        got = ours[f"r{i}"]
        assert got["tokens"] == theirs[f"r{i}"]["tokens"], f"r{i}"
        assert got["tokens"] == reference_generate(model, tparams, p, 8)
        assert got["finish_reason"] == REASON_LENGTH


def test_engine_eos_stops_generation(models):
    _, model, params = models
    tparams = params_from_numpy(params, "cpu")
    prompt = seeded_prompts(1, seed=7)[0]
    ref = reference_generate(model, tparams, prompt, 8)
    eos = ref[2]
    engine = InferenceEngine(model, params,
                             config=serve_config(eos_token_id=eos),
                             device="cpu")
    rid = engine.submit(prompt, max_new_tokens=8)
    out = engine.run()[rid]
    assert out["tokens"] == reference_generate(model, tparams, prompt, 8,
                                               eos_token_id=eos)
    assert out["finish_reason"] == REASON_EOS and len(out["tokens"]) < 8


def test_engine_bf16_ingestion_and_receipt(models):
    _, model, params = models
    engine = InferenceEngine(model, params,
                             config=serve_config(weights_dtype="bfloat16"),
                             device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in
               jax.tree_util.tree_leaves(engine.params))
    assert engine._k_cache.dtype == torch.bfloat16
    for i, p in enumerate(seeded_prompts(3, seed=2)):
        engine.submit(p, max_new_tokens=4, request_id=f"r{i}")
    out = engine.run()
    assert all(len(r["tokens"]) == 4 and all(0 <= t < VOCAB
                                             for t in r["tokens"])
               for r in out.values())
    receipt = engine.serving_receipt()
    assert receipt["requests"] == 3 and receipt["generated_tokens"] == 12
    assert receipt["decode_iterations"] >= 3
    assert receipt["per_token_p99_seconds"] \
        >= receipt["per_token_p50_seconds"] > 0
    assert receipt["ttft_p50_seconds"] > 0
    assert receipt["tokens_per_second_per_chip"] > 0
    assert isinstance(receipt["flash_fwd_launches"], int)


def test_engine_from_hf_gpt2_serves_the_injected_weights(models):
    _, model, params = models
    hf = {"transformer": {
        "wte": {"embedding": params["wte"]},
        "wpe": {"embedding": params["wpe"]},
        "h": replace_gpt2_transformer_layer(params["blocks"], revert=True),
        "ln_f": params["ln_f"]}}
    engine = InferenceEngine.from_hf_gpt2(hf, GPT2Config(**TINY),
                                          config=serve_config(), device="cpu")
    prompt = seeded_prompts(1, seed=11)[0]
    rid = engine.submit(prompt, max_new_tokens=6)
    assert engine.run()[rid]["tokens"] == reference_generate(
        model, params_from_numpy(params, "cpu"), prompt, 6)


def test_engine_device_none_raises_without_cuda(models, monkeypatch):
    _, model, params = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model, params, config=serve_config())


def test_engine_strict_config_rejects_unknown_keys(models):
    _, model, params = models
    config = serve_config()
    config["inference"]["kv_block_sise"] = 8  # typo
    InferenceEngine(model, params, config=config, device="cpu")  # warns
    config["strict_config"] = True
    with pytest.raises(ValueError, match="kv_block_sise"):
        InferenceEngine(model, params, config=config, device="cpu")


@pytest.mark.parametrize("overrides,key", [
    ({"max_queue_depth": 8}, "inference.max_queue_depth"),
    ({"degrade_queue_depth": 4}, "inference.degrade_queue_depth"),
    ({"slo": {"ttft_ms": 100}}, "inference.slo.ttft_ms"),
    ({"slo": {"per_token_ms": 50}}, "inference.slo.per_token_ms"),
], ids=["shedding", "degradation", "slo_ttft", "slo_per_token"])
def test_engine_flags_knobs_of_unported_features(models, caplog, overrides,
                                                  key):
    """Shedding, degradation and SLO goodput are not served yet: setting
    one warns, naming the key, and strict_config rejects it; the knobs at
    their disabled defaults say nothing."""
    _, model, params = models
    with caplog.at_level("WARNING"):
        InferenceEngine(model, params, config=serve_config(), device="cpu")
    assert not caplog.records
    config = serve_config(**overrides)
    with caplog.at_level("WARNING"):
        InferenceEngine(model, params, config=config, device="cpu")
    assert any(key in r.getMessage() and "ROADMAP A12" in r.getMessage()
               for r in caplog.records)
    config["strict_config"] = True
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        InferenceEngine(model, params, config=config, device="cpu")


def test_engine_drain_finishes_in_flight_and_stops_admission(models):
    _, model, params = models
    engine = InferenceEngine(model, params, config=serve_config(),
                             device="cpu")
    for i, p in enumerate(seeded_prompts(6, seed=3)):
        engine.submit(p, max_new_tokens=4, request_id=f"r{i}")
    engine.step()
    active = engine.scheduler.active_count
    drained = engine.drain(deadline_secs=0)
    assert len(drained) == active and engine.scheduler.active_count == 0
    assert engine.scheduler.queue_depth == 6 - active
    with pytest.raises(RuntimeError, match="draining"):
        engine.submit([1, 2, 3])
    engine.close()
