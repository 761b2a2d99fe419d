"""The PyTorch port's data feeds (``repro_torch.data.feeds``) against the
reference's (``repro.data.feeds``): the feed half of
``tests/test_feeds_checkpoint.py`` run through both packages on the same
seeded inputs, and a seeded schedule of pumps, consumes, checkpoints and
restores in lockstep.  Records, cursors, ``state()`` dicts, joint buffers
and the ``feed.*`` counters must be equal exactly.  Feeds are host code,
so nothing here touches a device.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from repro_torch import obs as P_OBS  # noqa: E402
from repro_torch.data import feeds as P  # noqa: E402

from _torch_ref import reference_x64  # noqa: E402


@pytest.fixture(scope="module")
def R():
    with reference_x64():
        from repro.data import feeds
        yield feeds


def both(R):
    return (("port", P), ("reference", R))


def same_records(a, b):
    """Two record lists equal exactly: dicts with the same keys, numpy
    values of the same dtype, shape and elements, other values equal."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert sorted(x) == sorted(y)
            for k in x:
                same_records([x[k]], [y[k]])
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def feed_counters(obs):
    return {k: v for k, v in obs.snapshot().items() if k.startswith("feed.")}


def counter_delta(before, after):
    """Counter and gauge deltas (histograms by their count)."""
    out = {}
    for k, v in after.items():
        v0 = before.get(k, 0 if not isinstance(v, dict) else {"count": 0})
        out[k] = v["count"] - v0["count"] if isinstance(v, dict) else v - v0
    return out


# ---------------------------------------------------------------------------
# tests/test_feeds_checkpoint.py:23-115, both packages, results equal
# ---------------------------------------------------------------------------

def test_primary_feed_to_store(R):
    got = {}
    for name, F in both(R):
        seen = []
        feed = F.Feed("f", adaptor=F.SyntheticTokenAdaptor(8, 100),
                      store=lambda rs, seen=seen: seen.extend(rs))
        feed.pump(5)
        assert len(seen) == 5 and feed.cursor == 5
        assert seen[0]["tokens"].shape == (8,)
        got[name] = (seen, feed.state())
    same_records(got["port"][0], got["reference"][0])
    assert got["port"][1] == got["reference"][1]


def test_feed_udf_transform_and_filter(R):
    got = {}
    for name, F in both(R):
        feed = F.Feed("f", adaptor=F.SyntheticTokenAdaptor(8, 100),
                      udfs=[lambda r: r if r["doc_id"] % 2 == 0 else None,
                            lambda r: {**r, "extra": 1}])
        n = feed.pump(10)
        assert n == 5                      # odd docs filtered
        assert all("extra" in r for r in feed.joint.buffer)
        got[name] = (list(feed.joint.buffer), feed.cursor, feed.last_intake)
    same_records(got["port"][0], got["reference"][0])
    assert got["port"][1:] == got["reference"][1:] == (10, 10)


def test_secondary_feed_subscribes_to_joint(R):
    got = {}
    for name, F in both(R):
        primary = F.Feed("p", adaptor=F.SyntheticTokenAdaptor(8, 100))
        collected = []
        secondary = F.Feed("s", source_joint=primary.joint,
                           store=collected.extend)
        primary.pump(6)
        secondary.pump(4)
        secondary.pump(4)
        assert [r["doc_id"] for r in collected] == [0, 1, 2, 3, 4, 5]
        got[name] = (collected, secondary.state(), primary.state())
    same_records(got["port"][0], got["reference"][0])
    assert got["port"][1:] == got["reference"][1:]


def test_joint_multiple_subscribers_and_window(R):
    got = {}
    for name, F in both(R):
        joint = F.FeedJoint(window=16)
        joint.subscribe("a")
        joint.subscribe("b")
        joint.publish(list(range(6)))
        out = [joint.consume("a", 3), joint.consume("b", 6)]
        joint.publish(list(range(6, 12)))
        out.append(joint.consume("a", 100))
        assert out == [[0, 1, 2], list(range(6)), list(range(3, 12))]
        got[name] = (out, joint.base, list(joint.buffer),
                     dict(joint.subscribers), joint.published)
    assert got["port"] == got["reference"]


def test_joint_fall_behind_raises(R):
    got = {}
    for name, F in both(R):
        joint = F.FeedJoint(window=4)
        joint.subscribe("slow")
        joint.publish(list(range(4)))
        joint.subscribe("fast")
        joint.publish(list(range(4, 12)))   # slow falls out of the window
        with pytest.raises(RuntimeError) as e:
            joint.consume("slow", 1)
        got[name] = (str(e.value), joint.dropped, joint.base)
    assert got["port"] == got["reference"]


def test_deterministic_replay_after_seek(R):
    got = {}
    for name, F in both(R):
        a1 = F.SyntheticTokenAdaptor(16, 1000, seed=3)
        ref = a1.next_batch(7)
        a1.seek(0)
        again = a1.next_batch(7)
        same_records(ref, again)
        got[name] = again
    same_records(got["port"], got["reference"])


def test_redundant_intake_straggler_mitigation(R):
    """First-wins racing returns identical records regardless of winner."""
    got = {}
    for name, F in both(R):
        mk = lambda: F.SyntheticTokenAdaptor(8, 100, seed=5)  # noqa: E731
        lat = lambda replica, cursor: (0.5 if replica == 0 else 0.01) \
            if cursor >= 8 else (0.01 if replica == 0 else 0.5)  # noqa: E731
        red = F.RedundantIntake([mk(), mk()], latency=lat)
        recs = red.next_batch(8) + red.next_batch(8)
        assert red.stats["wins"] == [1, 1]
        same_records(recs, F.SyntheticTokenAdaptor(8, 100, seed=5)
                     .next_batch(16))
        got[name] = (recs, red.cursor)
    same_records(got["port"][0], got["reference"][0])
    assert got["port"][1] == got["reference"][1] == 16


def test_socket_adaptor_push_pull(R):
    got = {}
    for name, F in both(R):
        sock = F.SocketAdaptor()
        feed = F.Feed("s", adaptor=sock)
        sock.push([{"x": i} for i in range(5)])
        got[name] = (feed.pump(3), feed.pump(10), feed.state(),
                     list(feed.joint.buffer))
        assert got[name][:2] == (3, 2)
    assert got["port"] == got["reference"]


def test_batch_assembler(R):
    got = {}
    for name, F in both(R):
        asm = F.BatchAssembler(global_batch=4)
        feed = F.Feed("f", adaptor=F.SyntheticTokenAdaptor(8, 100),
                      store=asm)
        feed.pump(3)
        assert asm.take() is None
        feed.pump(3)
        b = asm.take()
        assert b["tokens"].shape == (4, 8) and b["labels"].shape == (4, 8)
        got[name] = (b, asm.backlog)
    same_records([got["port"][0]], [got["reference"][0]])
    same_records(got["port"][1], got["reference"][1])


# ---------------------------------------------------------------------------
# a seeded schedule in lockstep: records, cursors, state() and counters
# ---------------------------------------------------------------------------

def _schedule(F, obs, seed, overflow):
    """Run one seeded schedule of pumps, consumes, checkpoints and restores
    over a primary feed (a filtering UDF, a joint window of 48) and a
    secondary feed on its joint; return everything observable."""
    rng = np.random.default_rng(seed)
    before = feed_counters(obs)
    tag = f"lk{seed}{overflow}"
    stored, sec_stored, trace = [], [], []
    primary = F.Feed(f"{tag}p", adaptor=F.SyntheticTokenAdaptor(4, 50,
                                                                seed=seed),
                     udfs=[lambda r: r if r["doc_id"] % 5 else None],
                     store=stored.extend,
                     joint=F.FeedJoint(window=48, name=f"{tag}j",
                                       overflow=overflow))
    secondary = F.Feed(f"{tag}s", source_joint=primary.joint,
                       store=sec_stored.extend)
    ckpt = None
    for step in range(40):
        op = int(rng.integers(0, 5))
        try:
            if op <= 1:
                res = ("pump", primary.pump(int(rng.integers(1, 20))))
            elif op == 2:
                res = ("sec", secondary.pump(int(rng.integers(1, 30))))
            elif op == 3:
                ckpt = (primary.state(), secondary.state())
                res = ("state", ckpt)
            else:
                if ckpt is not None:
                    primary.restore(ckpt[0])
                    secondary.restore(ckpt[1])
                res = ("restore", primary.state(), secondary.state())
        except (RuntimeError, F.FeedOverflow) as e:
            res = ("raised", type(e).__name__, str(e))
        trace.append((step, res, primary.cursor, primary.last_intake,
                      secondary.cursor, primary.joint.base,
                      primary.joint.published, primary.joint.dropped,
                      dict(primary.joint.subscribers)))
    counters = {k: v for k, v in counter_delta(before, feed_counters(obs))
                .items() if tag in k}
    return trace, stored, sec_stored, list(primary.joint.buffer), counters


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("overflow", ["drop", "raise"])
def test_feed_schedule_lockstep(R, seed, overflow):
    """Pumps, secondary consumes, checkpoints and restores in a seeded
    order (a lagging secondary falls out of the window under ``drop`` and
    blocks publishes under ``raise``): every step's result, the cursors,
    the joint, the delivered records and the ``feed.*`` counters of both
    packages are equal."""
    port = _schedule(P, P_OBS, seed, overflow)
    ref = _schedule(R, R._obs, seed, overflow)
    assert port[0] == ref[0]
    for a, b in zip(port[1:4], ref[1:4]):
        same_records(a, b)
    assert port[4] == ref[4] and port[4]
    assert any(k.endswith(".records") for k in port[4])
