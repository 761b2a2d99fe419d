"""LSM-tiered KV cache (the reference's ``kvcache/lsm_cache.py``: paper
§4.3's storage rule applied to the decode KV cache).

  tail    (memtable)          [B, tail_cap, KV, hd]: per-token appends
  L1 ring (disk components)   [n1, B, tail_cap, KV, hd]: a full tail is
                              flushed (copied, then frozen) into the next slot
  L2      (merged component)  [B, max_len, KV, hd]: a full L1 ring is merged
                              (KV rows are position-sorted, so the merge is a
                              concatenation) into the big immutable region

Attention runs K9 per component (L2, every L1 slot, the tail) and merges
the un-normalized states by the associative logsumexp merge, then
normalizes once (``kernels/model_ops.lsm_decode_attention``).  An empty L1
slot is a component with ``valid_len`` 0.

Unlike the reference's pure functions, the port updates a cache in place
(the functions still return it): the buffers are written where they lie,
and the counters (``tail_len``, ``l1_count``, ``l2_len``, ``flushes``,
``merges``) are host ints, so a decode step never waits on the card to
decide whether to flush or merge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels import model_ops

__all__ = ["TieredCacheConfig", "init_tiered_cache", "tiered_update",
           "tiered_attend", "tiered_decode_attention", "cache_config_for",
           "tiered_from_prefill", "COUNTERS"]

COUNTERS = ("tail_len", "l1_count", "l2_len", "flushes", "merges")

Cache = Dict[str, Any]


@dataclass(frozen=True)
class TieredCacheConfig:
    tail_cap: int = 128
    l1_comps: int = 4
    max_len: int = 4096           # L2 capacity

    def __post_init__(self):
        assert self.max_len % self.tail_cap == 0


def init_tiered_cache(batch: int, kv_heads: int, head_dim: int,
                      ccfg: TieredCacheConfig,
                      dtype: torch.dtype = torch.bfloat16,
                      device: Optional[torch.device] = None) -> Cache:
    T, N = ccfg.tail_cap, ccfg.l1_comps
    tail = (batch, T, kv_heads, head_dim)
    z = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
    cache: Cache = {
        "tail_k": z(tail), "tail_v": z(tail),
        "l1_k": z((N,) + tail), "l1_v": z((N,) + tail),
        "l2_k": z((batch, ccfg.max_len, kv_heads, head_dim)),
        "l2_v": z((batch, ccfg.max_len, kv_heads, head_dim)),
    }
    cache.update(dict.fromkeys(COUNTERS, 0))
    return cache


def _merge_l1_into_l2(cache: Cache, ccfg: TieredCacheConfig) -> None:
    """Bulk-append the full L1 ring to L2 (the LSM merge)."""
    T, N = ccfg.tail_cap, ccfg.l1_comps
    n0 = cache["l2_len"]
    if n0 + N * T > cache["l2_k"].shape[1]:
        raise RuntimeError(f"tiered KV cache: L2 holds "
                           f"{cache['l2_k'].shape[1]} rows, the merge needs "
                           f"{n0 + N * T}")
    for part in ("k", "v"):
        l1 = cache["l1_" + part]
        cache["l2_" + part][:, n0:n0 + N * T] = l1.transpose(0, 1).reshape(
            l1.shape[1], N * T, *l1.shape[3:])
    cache["l2_len"] = n0 + N * T
    cache["l1_count"] = 0
    cache["merges"] += 1


def _flush_tail(cache: Cache, ccfg: TieredCacheConfig) -> None:
    """Freeze the full tail as the next L1 component (it becomes visible
    only by the ``l1_count`` increment, the validity bit of paper §4.4);
    merge when the ring is full."""
    i = cache["l1_count"]
    cache["l1_k"][i].copy_(cache["tail_k"])
    cache["l1_v"][i].copy_(cache["tail_v"])
    cache["l1_count"] = i + 1
    cache["tail_len"] = 0
    cache["flushes"] += 1
    if cache["l1_count"] >= ccfg.l1_comps:
        _merge_l1_into_l2(cache, ccfg)


def tiered_update(cache: Cache, k_new: torch.Tensor, v_new: torch.Tensor,
                  ccfg: TieredCacheConfig) -> Cache:
    """Append one token's KV ([B, 1, KV, hd]) to the tail; flush and merge
    as the thresholds trip."""
    if cache["tail_len"] >= ccfg.tail_cap:
        _flush_tail(cache, ccfg)
    t = cache["tail_len"]
    cache["tail_k"][:, t] = k_new[:, 0]
    cache["tail_v"][:, t] = v_new[:, 0]
    cache["tail_len"] = t + 1
    return cache


def tiered_attend(cache: Cache, q: torch.Tensor,
                  ccfg: TieredCacheConfig) -> torch.Tensor:
    """q: [B, H, hd] -> [B, H, hd]: K9 over L2, each L1 slot and the tail,
    merged by logsumexp (the LSM component merge)."""
    comps = [(cache["l2_k"], cache["l2_v"], cache["l2_len"])]
    comps += [(cache["l1_k"][i], cache["l1_v"][i],
               ccfg.tail_cap if i < cache["l1_count"] else 0)
              for i in range(ccfg.l1_comps)]
    comps.append((cache["tail_k"], cache["tail_v"], cache["tail_len"]))
    return model_ops.lsm_decode_attention(q, comps)


def tiered_decode_attention(cache: Cache, q: torch.Tensor,
                            k_new: torch.Tensor, v_new: torch.Tensor,
                            ccfg: TieredCacheConfig
                            ) -> Tuple[torch.Tensor, Cache]:
    """One decode step: append, then attend over all tiers."""
    cache = tiered_update(cache, k_new, v_new, ccfg)
    return tiered_attend(cache, q, ccfg), cache


def cache_config_for(max_len: int, tail_cap: int = 256,
                     l1_comps: int = 4) -> TieredCacheConfig:
    """Tiered geometry for ``max_len`` tokens (L2 a component multiple
    covering max_len, plus one ring)."""
    tail_cap = min(tail_cap, max(max_len, 1))
    l2 = -(-max_len // tail_cap) * tail_cap + l1_comps * tail_cap
    return TieredCacheConfig(tail_cap=tail_cap, l1_comps=l1_comps,
                             max_len=l2)


def tiered_from_prefill(k: torch.Tensor, v: torch.Tensor,
                        ccfg: TieredCacheConfig,
                        dtype: Optional[torch.dtype] = None) -> Cache:
    """LSM bulk load: a prefilled [B, S, KV, hd] block arrives presorted and
    installs directly as one L2 component."""
    B, S, KV, hd = k.shape
    cache = init_tiered_cache(B, KV, hd, ccfg, dtype or k.dtype, k.device)
    assert S <= ccfg.max_len, (S, ccfg.max_len)
    cache["l2_k"][:, :S] = k
    cache["l2_v"][:, :S] = v
    cache["l2_len"] = S
    return cache
