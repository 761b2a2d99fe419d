"""The port's training path against the reference, on the CPU (the port
runs its kernels' plain versions there), from the same weights and the
same numpy-seeded batches: the loss and every gradient leaf
(``make_loss_fn``: whole and chunked cross-entropy, a loss mask, the three
remat policies), the AdamW update, three train steps (gradient
accumulation, error-feedback compression), and mirrors of the reference's
optimizer and train-step tests (tests/test_dedup_moe_optim.py:118-181,
tests/test_train_features.py).  The MoE cases of those files
(``test_compressed_training_converges`` on olmoe) wait for the port's MoE
slice.

Tolerances (both packages compute in float32, summing in different
orders: XLA's dots and scans against torch's matmul and the plain
versions):
  * loss, nll and accuracy: rtol 1e-5 (they agree to ~1e-7);
  * a gradient leaf: within 1e-4 of that leaf's largest magnitude (they
    agree to ~1e-6 of it);
  * the AdamW update on the same gradients: rtol 1e-6 (the same float32
    operations in the same order; sqrt and division may round apart by
    an ulp), the norms and, under clipping, the moments 1e-5 (see
    ``test_adamw_update_matches_reference``);
  * parameters after three train steps: within ``STEP_ATOL`` but for a
    few entries (see there).
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
from repro.models import model as RM  # noqa: E402
from repro.models.layers import init_params as r_init  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.runtime.collectives import int8_encode as r_int8_encode  # noqa
from repro.training import train_step as RS  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models.carry import (params_from_reference,  # noqa: E402
                                      train_state_from_reference)
from repro_torch.models.layers import init_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim.grad_compress import ef_quantize, ef_state  # noqa
from repro_torch.runtime.collectives import int8_decode, int8_encode  # noqa
from repro_torch.training.train_step import (init_train_state,  # noqa: E402
                                             make_train_step,
                                             value_and_grad)

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ADAM_RTOL = 1e-6
B, S = 2, 20                   # loss_chunk 8 pads 20 to 24
VARIANTS = ("whole", "chunk8", "mask")
REMAT = ("full", "dots", "nothing")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _leaf_close(got, want, tol=GRAD_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, \
        (float(np.abs(got - want).max()), scale)


def _variant_cfgs(variant):
    r = r_reduced(r_get_config("deepseek-67b"))
    p = reduced(get_config("deepseek-67b"))
    if variant == "chunk8":
        r, p = (dataclasses.replace(c, loss_chunk=8) for c in (r, p))
    return r, p


@pytest.fixture(scope="module")
def loss_ref():
    """The reference's loss, metrics and gradients for each variant, one
    jitted ``value_and_grad`` each, and the port's carried weights."""
    rcfg, pcfg = _variant_cfgs("whole")
    # jitted: op by op, jax.random's draws take seconds
    rparams = jax.jit(lambda key: r_init(RM.model_specs(rcfg), key,
                                         jnp.float32))(jax.random.key(0))
    pparams = params_from_reference(jax.tree.map(np.asarray, rparams), pcfg,
                                    CPU)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, rcfg.vocab_size, (B, S + 1), dtype=np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    out = {"pparams": pparams, "rparams": rparams}
    for variant in VARIANTS:
        rc, _ = _variant_cfgs(variant)
        batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
        if variant == "mask":
            batch["loss_mask"] = mask
        fn = jax.jit(jax.value_and_grad(RM.make_loss_fn(rc), has_aux=True))
        (loss, metrics), grads = fn(
            rparams, {k: jnp.asarray(v) for k, v in batch.items()})
        out[variant] = {
            "batch": batch, "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": params_from_reference(jax.tree.map(np.asarray, grads),
                                           pcfg, CPU)}
    return out


def _port_loss(loss_ref, variant, remat):
    _, pcfg = _variant_cfgs(variant)
    pcfg = dataclasses.replace(pcfg, remat_policy=remat)
    return value_and_grad(PM.make_loss_fn(pcfg), loss_ref["pparams"],
                          loss_ref[variant]["batch"])


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("variant", VARIANTS)
def test_loss_and_grads_match_reference(loss_ref, variant, remat):
    loss, metrics, grads = _port_loss(loss_ref, variant, remat)
    want = loss_ref[variant]
    assert float(loss) == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert sorted(metrics) == sorted(want["metrics"]) == \
        ["accuracy", "loss", "nll"]
    for k, v in want["metrics"].items():
        assert float(metrics[k]) == pytest.approx(v, rel=LOSS_RTOL), k
    got, ref = tree_leaves(grads), tree_leaves(want["grads"])
    assert len(got) == len(ref) == len(tree_leaves(loss_ref["pparams"]))
    for g, r in zip(got, ref):
        _leaf_close(g, r)


@pytest.mark.parametrize("variant", VARIANTS)
def test_remat_policies_give_identical_numbers(loss_ref, variant):
    """Recomputing a layer's forward in the backward ("full", "dots")
    gives the same bits as keeping everything ("nothing")."""
    base = _port_loss(loss_ref, variant, "nothing")
    for remat in ("full", "dots"):
        loss, metrics, grads = _port_loss(loss_ref, variant, remat)
        assert torch.equal(loss, base[0])
        for a, b in zip(tree_leaves(grads), tree_leaves(base[2])):
            assert torch.equal(a, b), remat


def test_masked_positions_carry_no_gradient(loss_ref):
    """With every position masked but one, the loss is that position's
    NLL; ``prefix_emb`` rows are left out of the loss."""
    _, pcfg = _variant_cfgs("whole")
    batch = dict(loss_ref["whole"]["batch"])
    mask = np.zeros((B, S), np.float32)
    mask[1, 5] = 1.0
    loss, metrics = PM.make_loss_fn(pcfg)(loss_ref["pparams"],
                                          {**batch, "loss_mask": mask})
    logits = PM._head(loss_ref["pparams"], PM._forward(
        loss_ref["pparams"], torch.as_tensor(batch["tokens"]).long(), None,
        pcfg, "train")[0], pcfg)
    nll = torch.logsumexp(logits[1, 5], -1) - logits[1, 5,
                                                      int(batch["labels"][1, 5])]
    assert float(loss) == pytest.approx(float(nll), rel=1e-6)
    prefix = torch.zeros((B, 3, pcfg.d_model))
    lp, _ = PM.make_loss_fn(pcfg)(loss_ref["pparams"],
                                  {**batch, "prefix_emb": prefix})
    assert torch.isfinite(lp)


# ---------------------------------------------------------------------------
# AdamW and the int8 codec
# ---------------------------------------------------------------------------

def _tree(rng, like):
    """A numpy tree shaped like the port's parameters (dicts and a list of
    per-layer dicts), normal values times 0.01."""
    return tree_map(lambda p: (rng.standard_normal(tuple(p.shape))
                               .astype(np.float32) * 0.01), like)


def _exact_norm(tree):
    return float(np.sqrt(sum(float(np.sum(_np(x).astype(np.float64) ** 2))
                             for x in tree_leaves(tree))))


@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_matches_reference(loss_ref, clipped):
    """Two updates on the same numpy gradients, both packages over the
    same per-layer tree (the reference's ``update`` is generic over
    pytrees): parameters, m, v and lr at rtol 1e-6 (an entry the update
    nearly cancels within 1e-6 of the step lr, or of the largest m of its
    leaf).  The norms: XLA's
    float32 sum of a leaf's squares strays from the exact sum by up to
    ~6e-6 (measured on the embedding leaf with a large row), the port's
    (float64 accumulation, rounded once) by ~1e-8; so grad_norm and
    param_norm are held to the reference at rtol 1e-5 and to the exact
    float64 norm at rtol 1e-6.  With clipping engaged the clip factor
    carries the norm's difference into m (and twice into v): rtol 1e-5
    there; the parameters' step m / sqrt(v) does not see it."""
    cfg = adamw.OptimizerConfig(peak_lr=1e-2, warmup_steps=1,
                                decay_steps=10)
    rcfg = RA.OptimizerConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=10)
    rng = np.random.default_rng(3)
    params_np = tree_map(lambda p: p.numpy().copy(), loss_ref["pparams"])
    rparams = jax.tree.map(jnp.asarray, params_np)
    pparams = tree_map(torch.from_numpy, params_np)
    rstate, pstate = RA.init(rparams), adamw.init(pparams)
    mv_rtol = 1e-5 if clipped else ADAM_RTOL
    rupdate = jax.jit(lambda gr, st, pr: RA.update(gr, st, pr, rcfg))
    for _ in range(2):
        g = _tree(rng, pparams)
        if clipped:
            g["embed"][3] *= 1e3
        else:                                     # global norm below 1
            g = tree_map(lambda x: x * 0.1, g)
        rparams, rstate, rm = rupdate(jax.tree.map(jnp.asarray, g), rstate,
                                      rparams)
        pparams, pstate, pm = adamw.update(tree_map(torch.from_numpy, g),
                                           pstate, pparams, cfg)
        assert (float(pm["grad_norm"]) > 1.0) is clipped
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]),
                                                rel=ADAM_RTOL)
        for name, tree in (("grad_norm", g), ("param_norm", pparams)):
            assert float(pm[name]) == pytest.approx(float(rm[name]),
                                                    rel=1e-5), name
            assert float(pm[name]) == pytest.approx(_exact_norm(tree),
                                                    rel=ADAM_RTOL), name
        assert int(pstate["step"]) == int(rstate["step"])
        # an entry the update nearly cancels (p - lr u, b1 m + (1 - b1) g)
        # is held to 1e-6 of the step lr, or of the moment leaf's largest
        # magnitude
        for got, want, rtol, atol in (
                (pparams, rparams, ADAM_RTOL, lambda b: ADAM_RTOL
                 * cfg.peak_lr),
                (pstate["m"], rstate["m"], mv_rtol,
                 lambda b: ADAM_RTOL * float(np.abs(b).max())),
                (pstate["v"], rstate["v"], mv_rtol, lambda b: 0)):
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                b = np.asarray(b)
                np.testing.assert_allclose(_np(a), b, rtol=rtol,
                                           atol=atol(b))


def test_adamw_update_leaves_inputs_unless_donated(loss_ref):
    p = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    g = {"w": torch.full((3, 2), 0.5), "b": torch.full((2,), 0.5)}
    st = adamw.init(p)
    cfg = adamw.OptimizerConfig(peak_lr=0.1, warmup_steps=0)
    new, st2, _ = adamw.update(g, st, p, cfg)
    assert torch.equal(p["w"], torch.ones(3, 2))
    assert torch.equal(st["m"]["w"], torch.zeros(3, 2))
    donated, st3, _ = adamw.update(g, st, p, cfg, donate=True)
    assert donated["w"] is p["w"] and torch.equal(p["w"], new["w"])
    assert st3["m"]["w"] is st["m"]["w"] and torch.equal(st["m"]["w"],
                                                          st2["m"]["w"])
    # decay on matrices only: the vector moved by the Adam step alone
    assert float(new["b"][0]) > float(new["w"][0, 0])


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 1000])
def test_schedule_matches_reference(step):
    cfg = adamw.OptimizerConfig(peak_lr=1.0, warmup_steps=10,
                                decay_steps=100, min_lr_ratio=0.1)
    rcfg = RA.OptimizerConfig(peak_lr=1.0, warmup_steps=10,
                              decay_steps=100, min_lr_ratio=0.1)
    assert float(adamw.schedule(step, cfg)) == pytest.approx(
        float(RA.schedule(jnp.int32(step), rcfg)), rel=ADAM_RTOL, abs=1e-12)


def test_adamw_converges_quadratic():
    cfg = adamw.OptimizerConfig(peak_lr=0.1, warmup_steps=5,
                                decay_steps=300, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params)
    target = torch.tensor([1.0, 1.0])
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw.update(g, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_schedule_shape():
    cfg = adamw.OptimizerConfig(peak_lr=1.0, warmup_steps=10,
                                decay_steps=100, min_lr_ratio=0.1)
    lrs = [float(adamw.schedule(s, cfg)) for s in (0, 5, 10, 55, 100, 1000)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0, abs=1e-2)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(0.1, abs=1e-2)
    assert lrs[5] == pytest.approx(0.1, abs=1e-2)


def test_grad_clipping():
    cfg = adamw.OptimizerConfig(max_grad_norm=1.0, peak_lr=1e-3)
    params = {"w": torch.ones(4)}
    state = adamw.init(params)
    huge = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw.update(huge, state, params, cfg)
    assert float(metrics["grad_norm"]) > 1e6  # reported pre-clip


def test_error_feedback_quantization_unbiased_over_steps():
    """EF property: accumulated quantized updates converge to the
    accumulated true gradient (the residual stays bounded)."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(512,)).astype(np.float32)
                              * 0.01)
    err = ef_state({"g": g_true})
    total_q = torch.zeros_like(g_true)
    for _ in range(30):
        q, err = ef_quantize({"g": g_true}, err)
        total_q = total_q + q["g"]
    np.testing.assert_allclose((total_q / 30).numpy(), g_true.numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("seed", range(20))
def test_int8_roundtrip_bounded_error(seed):
    rng = np.random.default_rng(seed * 50_021)
    x = torch.from_numpy(rng.normal(size=(300,)).astype(np.float32))
    q, s = int8_encode(x, block=64)
    y = int8_decode(q, s, tuple(x.shape))
    bound = np.repeat(s.numpy().ravel(), 64)[:300] * 0.5 + 1e-6
    assert np.all(np.abs((x - y).numpy()) <= bound)


@pytest.mark.parametrize("seed", range(3))
def test_int8_encode_matches_reference_exactly(seed):
    """Codes and scales bit for bit, ties included: a block whose largest
    magnitude is 127 has scale 1, so its halves round half to even in
    both packages; 1,001 values leave the last block of 64 partial."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1001,)).astype(np.float32)
    x[:8] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -127.0]
    q, s = int8_encode(torch.from_numpy(x), block=64)
    rq, rs = r_int8_encode(jnp.asarray(x), block=64)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


# ---------------------------------------------------------------------------
# the train step against the reference's, from carried state
# ---------------------------------------------------------------------------

# Three steps.  AdamW moves a parameter by about lr a step whatever its
# gradient's size (the first step is g / (|g| + eps)), so where a step's
# gradient is near eps = 1e-8 the step hinges on the gradient's last
# digits: ~1e-6 relative gradient differences then move a few entries in
# 10^4 by up to ~2e-5 after three steps (measured).  Every entry is held
# within 1e-4 (a tenth of a step at lr = 1e-3, so a step clipped,
# scheduled or decayed differently still fails), and all but one in 10^3
# within 1e-6.  With compression, an entry whose gradient / scale lies
# within the gradients' difference of an int8 rounding tie gets a
# compressed gradient a whole quantization step apart, which can reverse
# its Adam step: such entries are held to 2 lr a step, and up to one in
# 10^2 may lie outside 1e-6 (1.8e-3 measured).
STEP_ATOL = 1e-6
STEP_ATOL_ALL = 1e-4
STEP_OUTLIERS = 1e-3
STEP_OUTLIERS_COMPRESSED = 1e-2
STEPS = 3
TB = 4                         # global batch (two microbatches of 2)


def _step_cfgs():
    """Both packages' reduced deepseek-67b; the reference unrolled
    (``scan_layers=False``, the same numbers as its scan) so its norm
    scales are [d] leaves, as the port's are: stacked over layers they are
    [L, d], and its update decays every leaf of two or more dimensions.
    (The port reads ``scan_layers`` only to carry the reference's trees.)"""
    return tuple(dataclasses.replace(c, scan_layers=False) for c in (
        r_reduced(r_get_config("deepseek-67b")),
        reduced(get_config("deepseek-67b"))))


def _unrolled(rparams, num_layers):
    """The reference's scan-layout weights (``blocks/pos0`` stacked over
    layers) as its unrolled layout (``blocks/cycle{c}/pos0``)."""
    out = dict(rparams)
    out["blocks"] = {f"cycle{c}": {"pos0": jax.tree.map(
        lambda x: x[c], rparams["blocks"]["pos0"])}
        for c in range(num_layers)}
    return out


@pytest.fixture(scope="module")
def step_setup(loss_ref):
    rcfg, pcfg = _step_cfgs()
    rparams = _unrolled(loss_ref["rparams"], rcfg.num_layers)
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(STEPS):
        toks = rng.integers(0, rcfg.vocab_size, (TB, 17), dtype=np.int32)
        batches.append({"tokens": toks[:, :16], "labels": toks[:, 1:]})
    return rcfg, pcfg, rparams, batches


@pytest.mark.parametrize("grad_accum,compress", [(1, False), (2, False),
                                                 (1, True)])
def test_train_steps_match_reference(step_setup, grad_accum, compress):
    rcfg, pcfg, rparams, batches = step_setup
    opt = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10)
    rstep = jax.jit(RS.make_train_step(rcfg, RA.OptimizerConfig(**opt),
                                       grad_accum=grad_accum,
                                       compress=compress))
    rstate = RS.init_train_state(rparams, RA.OptimizerConfig(**opt),
                                 compress)
    pparams = params_from_reference(jax.tree.map(np.asarray, rparams), pcfg,
                                    CPU)
    pstate = train_state_from_reference(jax.tree.map(np.asarray, rstate),
                                        pcfg, CPU)
    assert sorted(pstate) == sorted(init_train_state(
        pparams, adamw.OptimizerConfig(**opt), compress))
    pstep = make_train_step(pcfg, adamw.OptimizerConfig(**opt),
                            grad_accum=grad_accum, compress=compress)
    rp, first_err = rparams, {}
    for batch in batches:
        rp, rstate, rm = rstep(rp, rstate,
                               {k: jnp.asarray(v) for k, v in batch.items()})
        pparams, pstate, pm = pstep(pparams, pstate, batch)
        if compress and not first_err:
            first_err["port"] = pstate["ef_err"]
            first_err["ref"] = params_from_reference(
                jax.tree.map(np.asarray, rstate["ef_err"]), pcfg, CPU)
        assert sorted(pm) == sorted(rm)
        for k in ("loss", "nll", "accuracy", "lr"):
            assert float(pm[k]) == pytest.approx(float(rm[k]),
                                                 rel=LOSS_RTOL), k
        for k in ("grad_norm", "param_norm"):
            assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-4), k
    want = params_from_reference(jax.tree.map(np.asarray, rp), pcfg, CPU)
    bound = 2 * opt["peak_lr"] * STEPS if compress else STEP_ATOL_ALL
    outliers = STEP_OUTLIERS_COMPRESSED if compress else STEP_OUTLIERS
    off, total = 0, 0
    for a, b in zip(tree_leaves(pparams), tree_leaves(want)):
        d = np.abs(_np(a) - _np(b))
        assert float(d.max()) <= bound
        off += int((d > STEP_ATOL).sum())
        total += d.size
    assert off <= outliers * total, (off, total)
    if compress:
        # after the first step (both from the same state): the residual of
        # an entry whose gradient / scale lies within the gradients'
        # difference of a rounding tie differs by a whole quantization
        # step; the rest agree to 1e-3 of the leaf's largest
        off, total = 0, 0
        for a, b in zip(tree_leaves(first_err["port"]),
                        tree_leaves(first_err["ref"])):
            d = np.abs(_np(a) - _np(b))
            off += int((d > 1e-3 * float(np.abs(_np(b)).max())).sum())
            total += d.size
        assert off <= STEP_OUTLIERS * total, (off, total)


def _port_setup(arch="internlm2-20b", Bt=4, St=16, **kw):
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(PM.model_specs(cfg), gen, CPU)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (Bt, St + 1), dtype=np.int32)
    return cfg, params, {"tokens": toks[:, :St], "labels": toks[:, 1:]}


def test_grad_accum_matches_full_batch():
    """grad_accum=2 over the same global batch == one full-batch step (the
    loss is mean-reduced, so gradients average exactly)."""
    cfg, params, batch = _port_setup()
    opt_cfg = adamw.OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                    decay_steps=10, weight_decay=0.0)
    p1, _, m1 = make_train_step(cfg, opt_cfg, grad_accum=1)(
        params, init_train_state(params, opt_cfg), batch)
    p2, _, m2 = make_train_step(cfg, opt_cfg, grad_accum=2)(
        params, init_train_state(params, opt_cfg), batch)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-5, rtol=2e-5)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-4)


def test_compressed_step_close_to_exact_and_residual_carried():
    cfg, params, batch = _port_setup()
    opt_cfg = adamw.OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                    decay_steps=10)
    pe, _, _ = make_train_step(cfg, opt_cfg)(
        params, init_train_state(params, opt_cfg), batch)
    pc, oc, _ = make_train_step(cfg, opt_cfg, compress=True)(
        params, init_train_state(params, opt_cfg, compress=True), batch)
    # int8 quantization perturbs but does not derail the step
    num = sum(float(((a - b) ** 2).sum()) for a, b in
              zip(tree_leaves(pe), tree_leaves(pc)))
    den = sum(float((a ** 2).sum()) for a in tree_leaves(pe))
    assert num / den < 1e-4
    # the residual buffer is carried and non-zero
    assert sum(float(e.abs().sum()) for e in tree_leaves(oc["ef_err"])) > 0


def test_optimized_profile_smoke_train_step():
    """The seq_shard / loss_chunk profile still trains (seq_shard is a
    sharding hint, nothing on one device; the loss switches to the chunked
    implementation)."""
    cfg, params, batch = _port_setup("deepseek-67b", Bt=2, seq_shard=True,
                                     loss_chunk=8)
    opt_cfg = adamw.OptimizerConfig(peak_lr=1e-3)
    _, _, m = make_train_step(cfg, opt_cfg)(
        params, init_train_state(params, opt_cfg), batch)
    assert np.isfinite(float(m["loss"]))
