"""The slice test of the port's fuzzy path: ngram postings, query
planning, batched verification, fuzzy selects and fuzzy keyword probes
through both ``run_query`` engines, and ``FuzzyJoin.run``, each held
against the reference (``repro``) on the same seeded inputs.

Tolerances: integers (CSR arrays, hit counts, thresholds) and Jaccard
values exactly (both divide the same integer counts in float64); rows
exactly under the canonical form of test_torch_query.py; the engines'
accounting (``rows_fallback``, ``fallback_reasons``,
``rows_vectorized``, ``rows_index_vectorized``, ``rows_fuzzy_vectorized``)
exactly.  The port runs its kernels' plain versions on the CPU.  The
reference is imported under a test-side ``jax.experimental.enable_x64``
shim that is removed again when this module's tests end.
"""

import contextlib
import random
import sys
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro_torch  # noqa: E402
from repro_torch import obs as P_obs  # noqa: E402
from repro_torch.columnar.batch import ColumnBatch as P_Batch  # noqa: E402
from repro_torch.configs import tinysocial as P_ts  # noqa: E402
from repro_torch.core import adm as P_adm  # noqa: E402
from repro_torch.core import algebra as P_A  # noqa: E402
from repro_torch.core import functions as P_fn  # noqa: E402
from repro_torch.core import lsm as P_lsm  # noqa: E402
from repro_torch.core.rewriter import RewriteConfig as P_RC  # noqa: E402
from repro_torch.data import dedup as P_dedup  # noqa: E402
from repro_torch import fuzzy as P_fz  # noqa: E402
from repro_torch.storage import dataset as P_dsm  # noqa: E402
from repro_torch.storage import query as P_q  # noqa: E402
from repro_torch.storage.carry import dataset_from_reference  # noqa: E402

PORT = types.SimpleNamespace(
    A=P_A, adm=P_adm, fn=P_fn, lsm=P_lsm, dsm=P_dsm, run_query=P_q.run_query,
    ts=P_ts, fz=P_fz, dedup=P_dedup, Batch=P_Batch, RewriteConfig=P_RC)


@contextlib.contextmanager
def _reference_x64():
    """Import the reference with ``jax.experimental.enable_x64`` restored
    as a wrapper of ``jax.enable_x64(True)``; on exit drop the reference
    modules imported meanwhile and the shim itself."""
    import jax.experimental as jexp
    had = hasattr(jexp, "enable_x64")
    before = set(sys.modules)
    if not had:
        @contextlib.contextmanager
        def enable_x64():
            with jax.enable_x64(True):
                yield
        jexp.enable_x64 = enable_x64
    try:
        yield
    finally:
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name == "repro" or name.startswith("repro."):
                mod = sys.modules.pop(name)
                parent, _, child = name.rpartition(".")
                if getattr(sys.modules.get(parent), child, None) is mod:
                    delattr(sys.modules[parent], child)
        if not had:
            del jexp.enable_x64


@pytest.fixture(scope="module")
def REF():
    with _reference_x64():
        from repro import fuzzy
        from repro.columnar import plancache
        from repro.columnar.batch import ColumnBatch
        from repro.configs import tinysocial
        from repro.core import adm, algebra, functions, lsm
        from repro.core.rewriter import RewriteConfig
        from repro.data import dedup
        from repro.storage import dataset, query
        plancache.set_enabled(False)
        try:
            yield types.SimpleNamespace(
                A=algebra, adm=adm, fn=functions, lsm=lsm, dsm=dataset,
                run_query=query.run_query, ts=tinysocial, fz=fuzzy,
                dedup=dedup, Batch=ColumnBatch, RewriteConfig=RewriteConfig)
        finally:
            plancache.set_enabled(True)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _canon(rows):
    return sorted(repr(sorted(r.items(), key=lambda kv: kv[0]))
                  for r in rows)


STAT_KEYS = ("rows_fallback", "fallback_reasons", "rows_vectorized",
             "rows_index_vectorized", "rows_fuzzy_vectorized")


def _agree(port_ds, ref_ds, port_plan, ref_plan, ref, vectorize=True):
    rows_p, ex_p = PORT.run_query(port_plan, port_ds, vectorize=vectorize)
    rows_r, ex_r = ref.run_query(ref_plan, ref_ds, vectorize=vectorize)
    assert _canon(rows_p) == _canon(rows_r)
    for key in STAT_KEYS:
        assert getattr(ex_p.stats, key) == getattr(ex_r.stats, key), key
    return rows_p, ex_p


VOCAB = ["tonight", "tonite", "coffee", "toffee", "fuzzy", "fuzz", "jax",
         "héllo", "hello", "中文字"]
VALUES = VOCAB + ["tonight coffee", "fuzzy héllo", "", None, 7]


# ---------------------------------------------------------------------------
# ngram postings and query planning
# ---------------------------------------------------------------------------

def _assert_postings_equal(p, r):
    assert p.k == r.k and p.n_rows == r.n_rows
    for name in ("grams", "offsets", "positions", "has_value"):
        got, want = getattr(p, name), getattr(r, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("k", [2, 3])
def test_gram_postings_csr_equal(REF, k):
    rng = random.Random(k)
    vals = [rng.choice(VALUES) for _ in range(60)]
    p = PORT.fz.GramPostings.from_values(vals, k)
    r = REF.fz.GramPostings.from_values(vals, k)
    _assert_postings_equal(p, r)
    rows = [{"id": i, "txt": v} for i, v in enumerate(vals)
            if isinstance(v, str)]
    pc = PORT.fz.GramPostings.from_column(
        PORT.Batch.from_rows(rows).columns["txt"], k)
    rc = REF.fz.GramPostings.from_column(
        REF.Batch.from_rows(rows).columns["txt"], k)
    _assert_postings_equal(pc, rc)
    for target in ("tonight", "héllo", "zzz"):
        qh = PORT.fz.value_gram_hashes(target, k)
        np.testing.assert_array_equal(qh,
                                      REF.fz.value_gram_hashes(target, k))
        hits = pc.hit_positions(qh)
        np.testing.assert_array_equal(hits, rc.hit_positions(qh))
        # the segments K4 counts cover exactly the same hits
        segs = pc.hit_segments(qh, 100)
        assert all(s.positions is pc.positions for s in segs)
        flat = np.concatenate([s.positions[s.start:s.stop] + s.offset
                               for s in segs]) if segs else hits
        np.testing.assert_array_equal(flat, hits + 100 if segs else hits)


SPECS = [("txt", "ed", "tonight", 0), ("txt", "ed", "tonight", 2),
         ("txt", "ed", "héllo", 5), ("txt", "jaccard", "coffee", 0.5),
         ("txt", "jaccard", "tonight coffee", 0.9),
         ("txt", "jaccard", "fuzzy", 0.4, 2)]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_query_grams_equal(REF, spec):
    for k in (2, 3):
        qp, tp = PORT.fz.query_grams(spec, k)
        qr, tr = REF.fz.query_grams(spec, k)
        np.testing.assert_array_equal(qp, qr)
        assert tp == tr
    assert PORT.fz.spec_gram_length(spec) == REF.fz.spec_gram_length(spec)


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_verify_values_and_mask_equal(REF, spec):
    rng = random.Random(str(spec))
    vals = [rng.choice(VOCAB) for _ in range(40)]
    k = PORT.fz.spec_gram_length(spec)
    np.testing.assert_array_equal(PORT.fz.verify_values(vals, spec, k),
                                  REF.fz.verify_values(vals, spec, k))
    rows = [{"id": i, "txt": rng.choice(VALUES)} for i in range(50)]
    mask = np.array([rng.random() < 0.7 for _ in rows])
    for pkg_rows in (rows, [dict(r, txt=r["txt"] if isinstance(r["txt"], str)
                                 else 3.5) for r in rows]):
        got = PORT.fz.verify_mask(PORT.Batch.from_rows(pkg_rows), mask,
                                  spec, k)
        want = REF.fz.verify_mask(REF.Batch.from_rows(pkg_rows), mask,
                                  spec, k)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# fuzzy selects across seeded lifecycles, both engines
# ---------------------------------------------------------------------------

def _record_type(adm):
    return adm.RecordType("FzT", (
        adm.Field("id", adm.INT64),
        adm.Field("g", adm.INT64),
        adm.Field("txt", adm.STRING, optional=True),
        adm.Field("kw", adm.STRING, optional=True),
    ), open=True)


def _fuzzy_spec(rng):
    base = rng.choice(VOCAB)
    if rng.random() < 0.5:
        j = rng.randrange(len(base))
        base = base[:j] + rng.choice("abxé") + base[j + 1:]
    if rng.random() < 0.5:
        return ("txt", "ed", base, rng.choice([0, 1, 2, 3]))
    if rng.random() < 0.4:
        base = base + " " + rng.choice(VOCAB)
    return ("txt", "jaccard", base, rng.choice([0.2, 0.4, 0.6, 0.9]))


def _fuzzy_plans(pkg, rng):
    """The variants of test_differential's fuzzy test: plain, exact,
    conjunct and spec_k (a gram-length-2 Jaccard spec on a k = 3
    index), plus a fuzzy keyword probe."""
    A = pkg.A
    plans = []
    for variant in ("plain", "exact", "conjunct", "spec_k"):
        spec = _fuzzy_spec(rng)
        if variant == "spec_k":
            spec = ("txt", "jaccard", spec[2], 0.3, 2)
        oracle = pkg.fz.fuzzy_predicate(spec)
        if variant == "conjunct":
            lo_g = rng.randrange(0, 3)
            plans.append(A.select(A.scan("D"),
                                  pred=lambda r, o=oracle, g=lo_g: o(r)
                                  and r["g"] >= g,
                                  fields=["txt", "g"], fuzzy=spec))
        else:
            plans.append(A.select(A.scan("D"), pred=oracle, fields=["txt"],
                                  fuzzy=spec,
                                  ranges_exact=variant == "exact"))
    token, ed = rng.choice(VOCAB), rng.choice([0, 1, 2])
    check, words = pkg.fn.edit_distance_check, pkg.fn.word_tokens
    plans.append(A.select(A.scan("D"),
                          pred=lambda r: "kw" in r and any(
                              check(t, token, ed) for t in words(r["kw"])),
                          fields=["kw"], keyword=("kw", token, ed)))
    return plans


def _replay(pkg, seed):
    """One seeded lifecycle (the rng draws, hence the data, are the same
    in both packages): inserts, batches, deletes, flushes, merges,
    crash_and_recover, an ngram index created before the records or
    after them (backfill); fuzzy queries at checkpoints, both engines."""
    rng = random.Random(seed)
    parts = rng.choice([2, 3])
    threshold = rng.choice([7, 19])
    ds = pkg.dsm.PartitionedDataset(
        "D", _record_type(pkg.adm), "id", num_partitions=parts,
        flush_threshold=threshold,
        merge_policy=pkg.lsm.TieredMergePolicy(k=rng.choice([2, 3])))
    late = rng.random() < 0.5
    if not late:
        ds.create_index("txt", kind="ngram")
    ds.create_index("kw", kind="keyword")

    def mk_row():
        r = {"id": rng.randrange(90), "g": rng.randrange(4)}
        if rng.random() < 0.85:
            r["txt"] = " ".join(rng.choice(VOCAB)
                                for _ in range(rng.randrange(1, 3)))
        if rng.random() < 0.7:
            r["kw"] = " ".join(rng.choice(VOCAB) for _ in range(2))
        if rng.random() < 0.3:
            r["x"] = rng.choice([rng.randrange(9), rng.choice(VOCAB)])
        return r

    out = []
    for step in range(rng.randrange(6, 10)):
        op = rng.choice(["insert", "batch", "delete", "flush", "merge",
                         "recover", "query"])
        if late and step == 3:
            ds.create_index("txt", kind="ngram")
            late = False
        if op == "insert":
            for _ in range(rng.randrange(1, threshold + 3)):
                ds.insert(mk_row())
        elif op == "batch":
            ds.insert_batch([mk_row()
                             for _ in range(rng.randrange(1, 2 * threshold))])
        elif op == "delete":
            for _ in range(rng.randrange(1, 6)):
                ds.delete(rng.randrange(90))
        elif op == "flush":
            for part in ds.partitions:
                part.primary.flush()
        elif op == "merge":
            part = ds.partitions[rng.randrange(parts)]
            valid = [c for c in part.primary.components if c.valid]
            if len(valid) >= 2:
                part.primary.merge(valid[:2])
        elif op == "recover":
            ds = ds.crash_and_recover()
        elif not late:
            out.append(ds)
            out.extend(_run_all(pkg, ds, _fuzzy_plans(pkg, rng)))
    if late:
        ds.create_index("txt", kind="ngram")
    out.extend(_run_all(pkg, ds, _fuzzy_plans(pkg, rng)))
    return out


def _run_all(pkg, ds, plans):
    res = []
    for plan in plans:
        for vectorize in (True, False):
            rows, ex = pkg.run_query(plan, {"D": ds}, vectorize=vectorize)
            res.append((_canon(rows),
                        tuple(getattr(ex.stats, k) for k in STAT_KEYS)))
    return res


@pytest.mark.parametrize("seed", range(8))
def test_fuzzy_lifecycle_agrees_with_reference(REF, seed):
    got = [r for r in _replay(PORT, 500 + seed) if isinstance(r, tuple)]
    want = [r for r in _replay(REF, 500 + seed) if isinstance(r, tuple)]
    assert len(got) == len(want) > 0
    for (rows_p, st_p), (rows_r, st_r) in zip(got, want):
        assert rows_p == rows_r
        assert st_p == st_r


# ---------------------------------------------------------------------------
# TinySocial: the fuzzy phase's queries, and warm repeats
# ---------------------------------------------------------------------------

def tinysocial_fuzzy_plans(pkg):
    A = pkg.A
    specs = [("name", "ed", "User Number 123", 1),
             ("name", "ed", "User Number 123", 3),
             ("name", "jaccard", "User Number 12", 0.8)]
    out = [A.select(A.scan("MugshotUsers"), pred=pkg.fz.fuzzy_predicate(s),
                    fields=["name"], fuzzy=s) for s in specs]
    check, words = pkg.fn.edit_distance_check, pkg.fn.word_tokens
    out.append(A.select(A.scan("MugshotUsers"),
                        pred=lambda r: "alias" in r and any(
                            check(t, "user123", 1)
                            for t in words(r["alias"])),
                        fields=["alias"], keyword=("alias", "user123", 1)))
    return out


@pytest.fixture(scope="module")
def tinysocial(REF):
    out = []
    for pkg in (PORT, REF):
        _, ds = pkg.ts.build_dataverse(400, 600, num_partitions=3,
                                       flush_threshold=64)
        ds["MugshotUsers"].create_index("name", kind="ngram")     # backfill
        ds["MugshotUsers"].create_index("alias", kind="keyword")
        out.append(ds)
    return out


@pytest.mark.parametrize("i", range(4))
def test_tinysocial_fuzzy_query_agrees_with_reference(REF, tinysocial, i):
    port, ref = tinysocial
    pp, rp = tinysocial_fuzzy_plans(PORT)[i], tinysocial_fuzzy_plans(REF)[i]
    rows, ex = _agree(port, ref, pp, rp, REF)
    assert rows and ex.stats.rows_fallback == 0
    assert ex.stats.rows_index_vectorized > 0
    _agree(port, ref, pp, rp, REF, vectorize=False)
    # the row engine's full scan, independent of the postings
    srows, _ = PORT.run_query(pp, port,
                              config=PORT.RewriteConfig(use_indexes=False))
    assert _canon(srows) == _canon(rows)
    # warm repeat: no new shape, and K4's posting positions stay resident
    k0 = P_obs.snapshot().get("kernel.t_occurrence_mask.h2d_bytes", 0)
    _, ex2 = PORT.run_query(pp, port, vectorize=True)
    assert ex2.stats.kernel_retraces == 0
    assert P_obs.snapshot().get("kernel.t_occurrence_mask.h2d_bytes",
                                0) == k0


def test_fuzzy_chain_launches_the_fuzzy_kernels(tinysocial):
    port, _ = tinysocial
    keys = ("t_occurrence_mask", "edit_distances", "set_intersect_counts")
    before = {k: P_obs.snapshot().get(f"kernel.{k}.dispatches", 0)
              for k in keys}
    for plan in tinysocial_fuzzy_plans(PORT):
        PORT.run_query(plan, port, vectorize=True)
    after = P_obs.snapshot()
    for k, v in before.items():
        assert after.get(f"kernel.{k}.dispatches", 0) > v, k


# ---------------------------------------------------------------------------
# FuzzyJoin
# ---------------------------------------------------------------------------

def _clusters(n_clusters, size, base, noise, vocab, seed):
    rng = random.Random(seed)
    recs = []
    for _ in range(n_clusters):
        common = [f"t{rng.randrange(vocab)}" for _ in range(base)]
        for _ in range(size):
            s = set(common[rng.randrange(3):])
            s.update(f"t{rng.randrange(vocab)}" for _ in range(noise))
            recs.append((len(recs), s))
    return recs


@pytest.mark.parametrize("wide", [False, True], ids=["bitset", "sorted"])
@pytest.mark.parametrize("batch_verify", [True, False])
def test_fuzzy_join_agrees_with_reference(REF, wide, batch_verify):
    """Small vocabularies take the bitset branch (A7), one past 2**15
    tokens the sorted-codes branch (K6)."""
    if wide:
        recs = _clusters(30, 8, 300, 140, 1 << 30, 1)
    else:
        recs = _clusters(20, 8, 30, 4, 500, 2)
    vocab = len(set().union(*(s for _, s in recs)))
    assert (vocab > 1 << 15) == wide
    kw = dict(threshold=0.3 if wide else 0.5, batch_verify=batch_verify,
              num_hashes=32, bands=16)
    got, st_p = PORT.dedup.FuzzyJoin(**kw).run(recs)
    want, st_r = REF.dedup.FuzzyJoin(**kw).run(recs)
    assert st_p == st_r and st_p["pairs"] > 0
    assert got == want


def test_fuzzy_join_handles_non_integer_record_ids(REF):
    for ids in [(1.5, 2.5, 3.25), (2 ** 63, 2 ** 63 + 7, 5),
                ("a", "b", "c")]:
        recs = [(ids[0], {"x", "y", "z"}), (ids[1], {"x", "y", "q"}),
                (ids[2], {"p", "q", "r"})]
        toks = dict(recs)
        cands = [(ids[0], ids[1]), (ids[1], ids[2]), (ids[0], ids[2])]
        got = PORT.dedup.FuzzyJoin(threshold=0.4).verify(cands, toks)
        assert got == REF.dedup.FuzzyJoin(threshold=0.4).verify(cands, toks)
        assert PORT.dedup.FuzzyJoin(threshold=0.2).run(recs) == \
            REF.dedup.FuzzyJoin(threshold=0.2).run(recs)


def test_minhash_signature_equal(REF):
    toks = [f"w{i}" for i in range(50)] + ["héllo", ""]
    for k, seed in ((32, 0), (16, 3)):
        np.testing.assert_array_equal(
            PORT.dedup.minhash_signature(toks, k, seed),
            REF.dedup.minhash_signature(toks, k, seed))


# ---------------------------------------------------------------------------
# carrying an ngram index across
# ---------------------------------------------------------------------------

def test_carry_keeps_the_ngram_gram_length(REF):
    """An ngram(2) index on the reference is carried as ngram(2), so the
    candidate sets, and the accounting, equal the reference's."""
    rng = random.Random(9)
    ref = REF.dsm.PartitionedDataset("D", _record_type(REF.adm), "id",
                                     num_partitions=2, flush_threshold=16)
    ref.create_index("txt", kind="ngram", gram_length=2)
    ref.insert_batch([{"id": i, "g": i % 4,
                       "txt": " ".join(rng.choice(VOCAB) for _ in range(2))}
                      for i in range(80)])
    port = dataset_from_reference(ref)
    assert port._ngram_specs == {"txt": 2}
    for spec in (("txt", "jaccard", "tonight coffee", 0.5, 2),
                 ("txt", "ed", "toffee", 1)):
        _agree({"D": port}, {"D": ref},
               PORT.A.select(PORT.A.scan("D"),
                             pred=PORT.fz.fuzzy_predicate(spec),
                             fields=["txt"], fuzzy=spec),
               REF.A.select(REF.A.scan("D"),
                            pred=REF.fz.fuzzy_predicate(spec),
                            fields=["txt"], fuzzy=spec), REF)
