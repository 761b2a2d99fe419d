"""Numpy transcriptions of the row-axis kernels of stacked K2 and A6's
second pass (``agg_kernel<NA, CHAIN, true>`` in
``src/repro_torch/kernels/csrc/agg_kernel.cuh`` and A6's mask-mode
``chain_mask_kernel`` in ``csrc/fused_chain.cu``) and of A6's stamped
occurrence flags (``csrc/fused_chain.cu``, ``chain_ops._flag_buffer``),
for the CPU tests to hold against the plain versions and the reference.

The mask-mode walk (``walk``): a grid of at most one wave of resident
blocks, block c taking logical blocks c * per ... of the R * nblk (L = r *
nblk + b), one add of its counts per (block, row) segment.  The fold
(``rows_raw``): block b of row r (grid (nblk, R)) folds exactly what
block b of a one-row launch folds on that row.  A block's partial follows
the kernel's lane layout and fold order (thread (warp, lane) takes rows
256 warp + 64 k + 2 lane + e of each 2,048-row iteration, in the order b
= 2 k + e; a warp folds its lanes by a shuffle-down tree keeping the lower
lane on a tie; the block folds its warps in order), and the row fold takes
the blocks as the kernel's last block does (lane l folds blocks l, l + 32,
... in order, then the shuffle tree).  Integer slots do not depend on the
order; the float64 min and max do (which NaN, which of -0.0 / +0.0), so
they are folded exactly; float64 sums are the 1,024-row nodes and their
32-ary tree.

The second stacked K2 design (``rows_agg_kernel`` in ``csrc/
filter_aggregate.cu``, ``k2s_walk``): a row's grid of G blocks, block g
taking logical blocks [g per, (g + 1) per) with their chunks; counts and
integer slots one partial a grid block, the float64 min / max a partial
per logical block (folded as above), the float64 sums' nodes a ticket a
chunk on its group of 32 nodes, whose last chunk's block folds the group
into the level above, and on up a ticket a group at every level, so the
block completing the top group writes the sum."""

import numpy as np

THREADS, RUN, WARPS, CHUNK, TREE_W = 256, 8, 8, 2048, 32
MAX_BLOCKS = 264
I64 = np.iinfo(np.int64)


def agg_blocks(n):
    return max(1, min(-(-n // CHUNK), MAX_BLOCKS))


def walk(rows, nblk, wave):
    """[(block, [L ...])] of the one-wave grid and the count adds
    [(block, row, logical blocks)] in each block's order."""
    items = rows * nblk
    per = -(-items // wave)
    grid = -(-items // per)
    blocks, tickets = [], []
    for c in range(grid):
        ls = list(range(c * per, min((c + 1) * per, items)))
        blocks.append((c, ls))
        seg = 0
        for i, L in enumerate(ls):
            seg += 1
            if i + 1 == len(ls) or (L + 1) % nblk == 0:
                tickets.append((c, L // nblk, seg))
                seg = 0
    assert grid <= wave
    return blocks, tickets


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float64).view(np.int64)


def _scalar_bits(x):
    return int(np.array(x, dtype=np.float64).view(np.int64))


def _sum_bits(x):
    """A float64 sum's bits as the kernels write them: a NaN as the
    canonical quiet NaN (which input NaN an add keeps is the compiler's
    operand order, ``agg_kernel.cuh:sum_bits``)."""
    return _scalar_bits(np.nan if np.isnan(x) else x)


def _f64(bits):
    return np.asarray(bits, dtype=np.int64).view(np.float64)


def _comb(op, a, b):
    """The kernel's comb on int64 slot bits (float64 ops on raw bits)."""
    if op == "add":
        return (a.astype(np.uint64) + b.astype(np.uint64)).astype(np.int64)
    if op == "min":
        return np.minimum(a, b)
    if op == "max":
        return np.maximum(a, b)
    x, y = _f64(a), _f64(b)
    better = (y < x) if op == "fmin" else (y > x)
    take_b = ~np.isnan(x) & (np.isnan(y) | better)
    return np.where(take_b, b, a)


def _ident(op):
    return {"add": 0, "min": I64.max, "max": I64.min,
            "fmin": _scalar_bits(np.inf), "fmax": _scalar_bits(-np.inf)}[op]


def _warp_tree(op, v):
    """Shuffle-down tree over the last axis (32 lanes); lane 0's value."""
    v = v.copy()
    for off in (16, 8, 4, 2, 1):
        v[..., :32 - off] = _comb(op, v[..., :32 - off], v[..., off:32])
    return v[..., 0]


def _lane_rows(lo):
    """[warp, lane, b] row indices of the iteration starting at row lo."""
    w = np.arange(WARPS)[:, None, None]
    i = np.arange(32)[None, :, None]
    b = np.arange(RUN)[None, None, :]
    return lo + 256 * w + 64 * (b >> 1) + 2 * i + (b & 1)


def _block_partial(op, vals, sel, n, nblk, blk):
    """Logical block blk's partial of one slot: vals int64 bits [n], sel
    bool [n] (rows outside sel meet the identity)."""
    acc = np.full((WARPS, 32), _ident(op), dtype=np.int64)
    wruns = -(-n // 256)
    for wr0 in range(blk * WARPS, wruns, nblk * WARPS):
        rows = _lane_rows(wr0 * 256)
        inside = rows < n
        r = np.where(inside, rows, 0)
        x = np.where(inside & sel[r], vals[r], _ident(op))
        for b in range(RUN):
            acc = _comb(op, acc, x[:, :, b])
    per_warp = _warp_tree(op, acc)
    out = per_warp[0]
    for w in range(1, WARPS):
        out = _comb(op, out, per_warp[w])
    return out


def _row_fold(op, parts):
    """The last block's fold of nb partials: lane l takes blocks l, l + 32,
    ... in order, then the shuffle tree."""
    nb = len(parts)
    lanes = np.full(32, _ident(op), dtype=np.int64)
    for lane in range(min(nb, 32)):
        v = parts[lane]
        for q in range(lane + 32, nb, 32):
            v = _comb(op, np.int64(v), np.int64(parts[q]))
        lanes[lane] = v
    return int(_warp_tree(op, lanes))


def tree_sum_nodes(x, n):
    """A float64 column's sum as the kernel folds it: 32-row windows left to
    right from 0.0, 1,024-row nodes of 32 windows, then levels of 32 nodes
    (a missing child adds +0.0)."""
    pad = -n % (TREE_W * TREE_W)
    level = np.concatenate([x[:n], np.zeros(pad)])
    first = True
    while first or level.shape[0] > 1:
        first = False
        level = np.concatenate(
            [level, np.zeros(-level.shape[0] % TREE_W)]).reshape(-1, TREE_W)
        s = np.zeros(level.shape[0])
        for q in range(TREE_W):
            s = s + level[:, q]
        level = s
    return level[0]


def row_slots(sel, cols, n, nblk):
    """One row's aggregate slots (valid survivors, sum, min, max a column;
    float64 slots as raw bits) folded as the kernel folds them."""
    out = []
    for x, valid in cols:
        ok = sel & valid
        if x.dtype == np.float64:
            bits = _bits(x)
            s = _sum_bits(tree_sum_nodes(np.where(ok, x, 0.0), n))
            mn = _row_fold("fmin", [_block_partial("fmin", bits, ok, n, nblk,
                                                   b) for b in range(nblk)])
            mx = _row_fold("fmax", [_block_partial("fmax", bits, ok, n, nblk,
                                                   b) for b in range(nblk)])
        else:
            v = x.astype(np.int64)
            s = int((v[ok].astype(np.uint64)).sum(dtype=np.uint64)
                    .astype(np.int64))
            mn = int(v[ok].min()) if ok.any() else I64.max
            mx = int(v[ok].max()) if ok.any() else I64.min
        out += [int(ok.sum()), s, mn, mx]
    return out


def rows_raw(masks, cols, rows, n, counts):
    """raw [rows, len(counts[0]) + 4 M]: each row's counts, then its
    slots; cols: per column (data [rows, n], valid [rows, n]) numpy."""
    nblk = agg_blocks(n)
    raw = []
    for r in range(rows):
        raw.append(list(counts[r]) + row_slots(
            masks[r], [(x[r], v[r]) for x, v in cols], n, nblk))
    return np.asarray(raw, dtype=np.int64)


class FlagPool:
    """A6's pooled flag buffer: bytes that are 0 or an earlier dispatch's
    stamp, a stamp 1 .. 255 a dispatch, zeroed when grown or wrapped."""

    def __init__(self):
        self.buf = np.zeros(0, dtype=np.uint8)
        self.stamp = 255
        self.clears = 0

    def dispatch(self, rows, nf, total, tiers, abo):
        """Scatter one dispatch's stamps; returns (flags view [rows, nf,
        total], stamp).  tiers: per field, per tier, positions [rows, w]."""
        need = rows * nf * total
        if self.buf.shape[0] < need:
            self.buf = np.full(need, 255, dtype=np.uint8)  # stale bytes
            self.stamp = 255
        self.stamp = self.stamp % 255 + 1
        if self.stamp == 1:
            self.buf[:] = 0
            self.clears += 1
        fl = self.buf[:need].reshape(rows, nf, total)
        t_all = 0
        for f, fp in enumerate(tiers):
            for pos in fp:
                w = pos.shape[1]
                for r in range(rows):
                    a, b, off = (int(v) for v in abo[r, t_all])
                    s = pos[r, max(a, 0):min(b, w)].astype(np.int64) + off
                    fl[r, f, s[(s >= 0) & (s < total)]] = self.stamp
                t_all += 1
        return fl, self.stamp


def chain_masks(fl, stamp, idx, n_live, total):
    """(cand, found) [rows, n] from stamped flags: live lanes whose slot
    (clamped into [0, total)) holds the stamp in field 0 / every field."""
    rows, n = idx.shape
    slot = np.clip(idx, 0, total - 1)
    live = np.arange(n)[None, :] < np.asarray(n_live)[:, None]
    hit = [np.take_along_axis(fl[:, f, :], slot, 1) == stamp
           for f in range(fl.shape[1])]
    cand = live & hit[0]
    found = cand.copy()
    for h in hit[1:]:
        found &= h
    return cand, found


GROUP_CHUNKS = 16                       # chunks of a group of 32 nodes


def k2s_grid(rows, n, sms=132, bps=2):
    """(per, G): logical blocks a grid block and grid blocks a row, G R
    about ``bps`` blocks on each of ``sms`` SMs (``launch_rows``)."""
    nb = agg_blocks(n)
    per = max(1, -(-nb * rows // (sms * bps)))
    return per, -(-nb // per)


def _fold32(vals):
    """One level of the window tree: 32 values at a time, left to right
    from 0.0 (a missing one adds +0.0)."""
    v = np.concatenate([vals, np.zeros(-len(vals) % TREE_W)])
    v = v.reshape(-1, TREE_W)
    s = np.zeros(v.shape[0])
    for q in range(TREE_W):
        s = s + v[:, q]
    return s


def _node_sums(x, n):
    """The 1,024-row node sums of a chunk-padded column: 32 windows each
    left to right from 0.0, then the windows the same way."""
    n_nodes = -(-n // (TREE_W * TREE_W))
    v = np.concatenate([x[:n], np.zeros(n_nodes * TREE_W * TREE_W - n)])
    return _fold32(_fold32(v))


def k2s_walk(masks, cols, rows, n, counts, sms=132, seed=0):
    """(raw [rows, len(counts[0]) + 4 M], walk) as the second stacked
    design computes them, each row's blocks finishing in a random order
    (``seed``); ``walk`` per row: (the chunks each grid block took, per
    level above the nodes the block that completed each group, per level
    the tickets' counts)."""
    rng = np.random.default_rng(seed)
    T = -(-n // CHUNK)
    nb = agg_blocks(n)
    per, G = k2s_grid(rows, n, sms)
    n_nodes = -(-n // (TREE_W * TREE_W))
    n_groups = -(-n_nodes // TREE_W)
    raw, walks = [], []
    for r in range(rows):
        took = []
        for g in range(G):
            lb = range(g * per, min(nb, (g + 1) * per))
            took.append([c for b in lb for c in range(b, T, nb)])
        order = rng.permutation(G)
        sizes = [n_groups]                  # groups a level
        while sizes[-1] > 1:
            sizes.append(-(-sizes[-1] // TREE_W))
        tickets = [np.zeros(m, dtype=np.int64) for m in sizes]
        finished = [{} for _ in sizes]
        for g in order:
            for c in took[g]:
                grp = c // GROUP_CHUNKS
                tickets[0][grp] += 1
                if tickets[0][grp] < min(GROUP_CHUNKS,
                                         T - grp * GROUP_CHUNKS):
                    continue
                finished[0][grp] = g        # fold_up, on up
                for lv in range(1, len(sizes)):
                    grp //= TREE_W
                    tickets[lv][grp] += 1
                    if tickets[lv][grp] < min(TREE_W, sizes[lv - 1]
                                              - grp * TREE_W):
                        break
                    finished[lv][grp] = g
        slots = list(counts[r])
        for x, valid in cols:
            xr, ok = x[r], masks[r] & valid[r]
            if xr.dtype == np.float64:
                bits = _bits(xr)
                nodes = _node_sums(np.where(ok, xr, 0.0), n)
                level = np.asarray([_fold32(nodes[TREE_W * q:
                                                  TREE_W * q + TREE_W])[0]
                                    for q in range(n_groups)])
                while level.shape[0] > 1:
                    level = _fold32(level)
                s = _sum_bits(level[0])
                mn = _row_fold("fmin", [_block_partial("fmin", bits, ok, n,
                                                       nb, b)
                                        for b in range(nb)])
                mx = _row_fold("fmax", [_block_partial("fmax", bits, ok, n,
                                                       nb, b)
                                        for b in range(nb)])
            else:
                v = xr.astype(np.int64)
                parts = []
                for g in order:
                    rws = np.zeros(n, dtype=bool)
                    for c in took[g]:
                        rws[c * CHUNK:(c + 1) * CHUNK] = True
                    sel = ok & rws
                    parts.append((
                        int(v[sel].astype(np.uint64).sum(dtype=np.uint64)
                            .astype(np.int64)),
                        int(v[sel].min()) if sel.any() else I64.max,
                        int(v[sel].max()) if sel.any() else I64.min))
                s = int(np.asarray([p[0] for p in parts], dtype=np.int64)
                        .astype(np.uint64).sum(dtype=np.uint64)
                        .astype(np.int64))
                mn = min(p[1] for p in parts)
                mx = max(p[2] for p in parts)
            slots += [int(ok.sum()), s, mn, mx]
        raw.append(slots)
        walks.append((took, finished, tickets))
    return np.asarray(raw, dtype=np.int64), walks
