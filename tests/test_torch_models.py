"""The port's model serving path against the reference, from the same
weights (the reference's ``init_params`` tree carried over by
``repro_torch.models.carry``) and the same numpy tokens: prefill logits
and KV caches, then greedy decode step by step on the flat cache and on
the LSM-tiered cache (flushes and merges included), for reduced
deepseek-67b (RMSNorm, SwiGLU) and starcoder2-3b (LayerNorm, GELU,
biases); and the counterparts of the reference's tiered-cache tests
(tests/test_sharding_kvcache.py:95,115) on the port's cache.

Tolerance on logits and caches: 1e-4 absolute and relative.  Both
packages compute in float32 at d_model 64; they sum in different orders
(XLA's dot and scan against torch's matmul and the kernels' plain
versions), which moves the logits by about 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.configs.base import reduced as r_reduced  # noqa: E402
from repro.configs.registry import get_config as r_get_config  # noqa: E402
from repro.kvcache import lsm_cache as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.layers import count_params as r_count  # noqa: E402
from repro.models.layers import init_params as r_init  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.kvcache import lsm_cache as PL  # noqa: E402
from repro_torch.launch.serve import prepare_cache  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.carry import (params_from_reference,  # noqa: E402
                                      states_from_reference)
from repro_torch.models.layers import count_params  # noqa: E402

TOL = 1e-4
B, S, STEPS = 2, 17, 20
TAIL, L1 = 4, 2
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _configs(arch):
    """(reference cfg, port cfg), reduced, with the tiered geometry."""
    kw = dict(kv_tail_cap=TAIL, kv_l1_comps=L1)
    return (dataclasses.replace(r_reduced(r_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


@pytest.fixture(scope="module", params=["deepseek-67b", "starcoder2-3b"])
def model(request):
    rcfg, pcfg = _configs(request.param)
    rparams = r_init(RM.model_specs(rcfg), jax.random.key(0), jnp.float32)
    tree = jax.tree.map(np.asarray, rparams)
    pparams = params_from_reference(tree, pcfg, CPU)
    rng = np.random.default_rng(len(request.param))
    tokens = rng.integers(0, rcfg.vocab_size, (B, S + STEPS + 1),
                          dtype=np.int32)
    rlogits, rcache = jax.jit(RM.make_prefill_fn(rcfg))(
        rparams, {"tokens": jnp.asarray(tokens[:, :S])})
    plogits, pcache = PM.make_prefill_fn(pcfg)(
        pparams, {"tokens": tokens[:, :S]})
    return {"rcfg": rcfg, "pcfg": pcfg, "rparams": rparams,
            "pparams": pparams, "tokens": tokens, "rlogits": rlogits,
            "rcache": rcache, "plogits": plogits, "pcache": pcache}


def test_prefill_logits_and_cache_match_reference(model):
    _close(model["plogits"], model["rlogits"])
    ref = states_from_reference(jax.tree.map(np.asarray, model["rcache"]),
                                model["pcfg"], CPU)
    assert len(model["pcache"]) == model["pcfg"].num_layers == len(ref)
    for got, want in zip(model["pcache"], ref):
        for name in ("k", "v"):
            assert got[name].shape == (B, S, model["pcfg"].num_kv_heads,
                                       model["pcfg"].resolved_head_dim)
            _close(got[name], want[name])


def _reference_decode_cache(rcfg, rcache, layout, max_len):
    """The reference serve path's cache conversion (launch/serve.py:60-80)."""
    if layout == "tiered":
        ccfg = RL.cache_config_for(max_len, rcfg.kv_tail_cap,
                                   rcfg.kv_l1_comps)
        fn = lambda k, v: RL.tiered_from_prefill(k, v, ccfg, jnp.float32)
        return {pos: (jax.vmap(fn)(st["k"], st["v"]) if st["k"].ndim == 5
                      else fn(st["k"], st["v"]))
                for pos, st in rcache.items()}

    def grow(x):
        pad = [(0, 0)] * x.ndim
        pad[-3] = (0, max_len - S)
        return jnp.pad(x, pad)
    return jax.tree.map(grow, rcache)


@pytest.mark.parametrize("layout", ["flat", "tiered"])
def test_decode_steps_match_reference(model, layout):
    """STEPS decode steps from the prefill, the reference's greedy token
    fed to both; logits equal at every step, and on the tiered cache the
    flushes and merges equal too (4 flushes, 2 merges here)."""
    rcfg = dataclasses.replace(model["rcfg"], kv_layout=layout)
    pcfg = dataclasses.replace(model["pcfg"], kv_layout=layout)
    max_len = S + STEPS
    rcache = _reference_decode_cache(rcfg, model["rcache"], layout, max_len)
    pcache = prepare_cache(pcfg, model["pcache"], max_len)
    rdecode = jax.jit(RM.make_decode_fn(rcfg))
    pdecode = PM.make_decode_fn(pcfg)
    tok = np.asarray(jnp.argmax(model["rlogits"], -1))[:, None]
    for t in range(STEPS):
        rl, rcache = rdecode(model["rparams"], rcache,
                             {"token": jnp.asarray(tok, jnp.int32),
                              "pos": jnp.int32(S + t)})
        pl, pcache = pdecode(model["pparams"], pcache,
                             {"token": tok, "pos": S + t})
        _close(pl, rl)
        tok = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    if layout == "tiered":
        ref = states_from_reference(jax.tree.map(np.asarray, rcache), pcfg,
                                    CPU)
        for got, want in zip(pcache, ref):
            for c in PL.COUNTERS:
                assert got[c] == want[c], (c, got[c], want[c])
            assert (got["flushes"], got["merges"]) == (4, 2)
            n = got["l2_len"]
            _close(got["l2_k"][:, :n], want["l2_k"][:, :n])


def test_decode_equals_prefill_of_one_more_token(model):
    """Decoding token S at pos = S gives the logits of prefilling S + 1
    tokens (the reference's tests/test_models_smoke.py:58), in the port."""
    pcfg = dataclasses.replace(model["pcfg"], kv_layout="flat")
    cache = prepare_cache(pcfg, model["pcache"], S + 8)
    got, _ = PM.make_decode_fn(pcfg)(
        model["pparams"], cache,
        {"token": model["tokens"][:, S:S + 1], "pos": S})
    want, _ = PM.make_prefill_fn(pcfg)(
        model["pparams"], {"tokens": model["tokens"][:, :S + 1]})
    _close(got, want, 5e-4)


@pytest.mark.parametrize("arch", ["deepseek-67b", "starcoder2-3b"])
def test_param_count_matches_reference(arch):
    """The full-width spec trees hold the same parameters."""
    assert count_params(PM.model_specs(get_config(arch))) == \
        r_count(RM.model_specs(r_get_config(arch)))


@pytest.mark.parametrize("layout", ["flat", "tiered"])
def test_cache_specs_match_reference(layout):
    """One decode-state spec per layer, with the shapes and dtypes of the
    reference's (stacked) ``cache_specs``."""
    rcfg, pcfg = (dataclasses.replace(c, kv_layout=layout)
                  for c in _configs("deepseek-67b"))
    ref = RT.cache_specs(rcfg, 3, 50)["pos0"]
    got = PT.cache_specs(pcfg, 3, 50)
    assert len(got) == pcfg.num_layers
    for layer in got:
        assert sorted(layer) == sorted(ref)
        for name, spec in layer.items():
            assert (rcfg.num_layers,) + spec.shape == ref[name].shape
            assert str(spec.dtype).split(".")[-1] == \
                np.dtype(ref[name].dtype).name


# ---------------------------------------------------------------------------
# the tiered cache (tests/test_sharding_kvcache.py:95,115)
# ---------------------------------------------------------------------------

def test_tiered_cache_exact_over_long_decode():
    rng = np.random.default_rng(0)
    Bc, KV, H, hd = 2, 2, 4, 16
    ccfg = PL.TieredCacheConfig(tail_cap=8, l1_comps=3, max_len=64)
    cache = PL.init_tiered_cache(Bc, KV, hd, ccfg, torch.float32)
    n = 40
    ks, vs = (torch.from_numpy(rng.normal(size=(Bc, n, KV, hd))
                               .astype(np.float32)) for _ in range(2))
    qs = torch.from_numpy(rng.normal(size=(Bc, n, H, hd)).astype(np.float32))
    for t in range(n):
        out, cache = PL.tiered_decode_attention(cache, qs[:, t],
                                                ks[:, t:t + 1],
                                                vs[:, t:t + 1], ccfg)
        want = flash_attention_ref(qs[:, t:t + 1], ks[:, :t + 1],
                                   vs[:, :t + 1], causal=False)[:, 0]
        _close(out, want, 2e-5)
    assert cache["flushes"] == (n - 1) // ccfg.tail_cap
    assert cache["merges"] == 1


def test_tiered_cache_lsm_counters_match_policy():
    """Flush when the tail fills, merge when the L1 ring fills (paper
    §4.3's merge policy); every appended token is in exactly one tier."""
    ccfg = PL.TieredCacheConfig(tail_cap=4, l1_comps=2, max_len=32)
    cache = PL.init_tiered_cache(1, 1, 8, ccfg, torch.float32)
    k = torch.ones((1, 1, 1, 8))
    q = torch.ones((1, 2, 8))
    for _ in range(17):
        cache = PL.tiered_decode_attention(cache, q, k, k, ccfg)[1]
    assert cache["flushes"] == 4
    assert cache["merges"] == 2
    assert cache["l2_len"] + cache["l1_count"] * 4 + cache["tail_len"] == 17
