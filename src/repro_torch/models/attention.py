"""GQA attention: training and prefill through K8 and cached decode
through K9 (the reference's ``models/attention.py``).

The reference's prefill calls ``flash_attention_xla``, a chunked XLA twin
of its Pallas kernel that computes exactly ``ref.flash_attention_ref``;
here that function is K8 (``kernels/model_ops.flash_attention``).  Decode
supports the reference's two cache layouts:

  flat    one [B, S_max, KV, hd] buffer pair per layer: the new token's KV
          is written at ``pos``, then K9 runs over the one component with
          ``valid_len = pos + 1`` and the state is normalized (the same
          function as the reference's masked softmax, attention.py:208-245)
  tiered  LSM components (``kvcache/lsm_cache.py``): K9 per component,
          merged by logsumexp

Caches are updated in place.  Layouts are the reference's: ``wq``
[d, H, hd], ``wk``/``wv`` [d, KV, hd], ``wo`` [H, hd, d], q [B, S, H, hd],
caches [B, S, KV, hd].
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import model_ops
from ..kernels.lsm_decode_attention import decode_partial
from ..kvcache import lsm_cache
from .layers import ParamSpec, apply_rope, dense

__all__ = ["attention_specs", "attention", "attention_prefill",
           "decode_attention", "decode_attention_tiered"]

Params = Dict[str, torch.Tensor]


def attention_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    specs = {
        "wq": ParamSpec((d, h, hd), ("d_model", "heads", "head_dim"),
                        "scaled"),
        "wk": ParamSpec((d, kv, hd), ("d_model", "kv_heads", "head_dim"),
                        "scaled"),
        "wv": ParamSpec((d, kv, hd), ("d_model", "kv_heads", "head_dim"),
                        "scaled"),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "d_model"),
                        "scaled"),
    }
    if cfg.use_bias:
        specs["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), "zeros")
        specs["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), "zeros")
        specs["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), "zeros")
        specs["bo"] = ParamSpec((d,), ("act_model",), "zeros")
    return specs


def _qkv(params: Params, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = dense(x, params["wq"], params.get("bq"))
    k = dense(x, params["wk"], params.get("bk"))
    v = dense(x, params["wv"], params.get("bv"))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(params: Params, out: torch.Tensor, x: torch.Tensor,
         cfg: ModelConfig) -> torch.Tensor:
    """[B, S, H, hd] -> [B, S, d]; a bf16 ``reduce_dtype`` rounds the
    product as the reference's preferred element type does."""
    h, hd = out.shape[2], out.shape[3]
    y = dense(out.reshape(*out.shape[:2], h * hd),
              params["wo"].reshape(h * hd, -1))
    if cfg.reduce_dtype == "bfloat16":
        y = y.to(torch.bfloat16)
    y = y.to(x.dtype)
    if cfg.use_bias:
        y = y + params["bo"].to(y.dtype)
    return y


def attention_prefill(params: Params, x: torch.Tensor,
                      positions: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: causal self-attention through K8, plus the layer's KV cache
    (the LSM bulk-load path).  x: [B, S, d]."""
    q, k, v = _qkv(params, x, cfg, positions)
    out = model_ops.flash_attention(q, k, v, causal=True)
    return _out(params, out, x, cfg), {"k": k, "v": v}


def attention(params: Params, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Training-mode self-attention (no cache): K8, whose gradient is K8's
    backward kernels on the card."""
    return attention_prefill(params, x, positions, cfg)[0]


def _decode_positions(x: torch.Tensor, pos: int) -> torch.Tensor:
    return torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)


def decode_attention(params: Params, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], pos: int,
                     cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step against a flat KV cache.  x: [B, 1, d]; cache
    {"k", "v": [B, S_max, KV, hd]}; ``pos`` the number of tokens already
    cached: the new token's KV goes to row ``pos`` and attention spans
    rows [0, pos]."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(params, x, cfg, _decode_positions(x, pos))
    cache["k"][:, pos] = k_new[:, 0]
    cache["v"][:, pos] = v_new[:, 0]
    acc, _, l = decode_partial(q[:, 0], cache["k"], cache["v"], pos + 1)
    out = (acc / torch.clamp(l, min=1e-20)[..., None]).to(x.dtype)
    return _out(params, out.reshape(B, 1, *out.shape[1:]), x, cfg), cache


def decode_attention_tiered(params: Params, x: torch.Tensor,
                            cache: Dict[str, Any], pos: int,
                            cfg: ModelConfig
                            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step against the LSM-tiered KV cache (paper C3): the new
    token appends to the tail, flush and merge fire on thresholds, and
    attention merges L2 + L1 components + tail.  The geometry is read from
    the cache's shapes."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(params, x, cfg, _decode_positions(x, pos))
    ccfg = lsm_cache.TieredCacheConfig(tail_cap=cache["tail_k"].shape[1],
                                       l1_comps=cache["l1_k"].shape[0],
                                       max_len=cache["l2_k"].shape[1])
    out, cache = lsm_cache.tiered_decode_attention(cache, q[:, 0], k_new,
                                                   v_new, ccfg)
    out = out.to(x.dtype).reshape(B, 1, *out.shape[1:])
    return _out(params, out, x, cfg), cache
