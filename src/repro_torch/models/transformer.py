"""Decoder blocks and the layer stack (the reference's
``models/transformer.py``), for the ``("attn", "mlp")`` pattern of the
dense models.

A model is ``num_layers`` blocks following ``cfg.block_pattern``.  The
reference scans over cycles with parameters stacked on a leading
``layers`` axis; here parameters and decode states are lists with one
entry per layer and the stack is a Python loop over them
(``models/carry.py`` unstacks the reference's trees in ``jax.lax.scan``'s
order).  The ``moe``, ``mamba``, ``mlstm`` and ``slstm`` mixers come with
a later slice of the port and raise ``NotImplementedError``.

Modes: ``train`` (no state; each layer's body wrapped by
``cfg.remat_policy``), ``prefill`` (returns each layer's KV cache) and
``decode`` (consumes and returns it; flat or tiered by ``cfg.kv_layout``).

Rematerialization in train mode, per layer as the reference's
``jax.checkpoint`` of its scan body: ``"full"`` keeps only the layer's
input (``torch.utils.checkpoint``, non-reentrant), so its forward, K7 and
K8 included, runs again inside the backward; ``"dots"`` also keeps the
outputs of the matrix products (a selective-checkpoint policy, the
counterpart of ``checkpoint_dots``); ``"nothing"`` keeps everything.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from ..configs.base import ModelConfig
from ..kvcache.lsm_cache import COUNTERS, cache_config_for
from . import attention as attn_mod
from .layers import ParamSpec, dense, layer_norm, rms_norm

__all__ = ["mlp_specs", "mlp_apply", "norm_specs", "apply_norm",
           "block_specs", "block_apply", "stack_specs", "run_stack",
           "cache_specs", "check_supported"]

LATER = {"moe": "the MoE slice", "mamba": "the SSM slice",
         "mlstm": "the xLSTM slice", "slstm": "the xLSTM slice"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a block the port does not run
    yet, naming the later slice that brings it."""
    for mixer, ffn in cfg.layer_pattern:
        for part in (mixer, ffn):
            if part in LATER:
                raise NotImplementedError(
                    f"{cfg.name}: the {part!r} block is not ported yet; it "
                    f"comes with {LATER[part]} of repro_torch")


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.ffn_kind == "swiglu":
        specs = {
            "wg": ParamSpec((d, ff), ("d_model", "d_ff"), "scaled"),
            "wu": ParamSpec((d, ff), ("d_model", "d_ff"), "scaled"),
            "wo": ParamSpec((ff, d), ("d_ff", "d_model"), "scaled"),
        }
    else:
        specs = {
            "wi": ParamSpec((d, ff), ("d_model", "d_ff"), "scaled"),
            "wo": ParamSpec((ff, d), ("d_ff", "d_model"), "scaled"),
        }
    if cfg.use_bias:
        specs["bi"] = ParamSpec((ff,), ("act_ff",), "zeros")
        specs["bo"] = ParamSpec((d,), ("act_model",), "zeros")
    return specs


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU or GELU (tanh form, jax.nn.gelu's default) MLP; the products
    are plain ``torch.matmul``, as the reference leaves them to XLA."""
    if cfg.ffn_kind == "swiglu":
        g = dense(x, params["wg"]).float()
        u = dense(x, params["wu"]).float()
        h = (F.silu(g) * u).to(x.dtype)
    else:
        h = dense(x, params["wi"]).float()
        if cfg.use_bias:
            h = h + params["bi"].float()
        h = F.gelu(h, approximate="tanh").to(x.dtype)
    y = dense(h, params["wo"])
    if cfg.reduce_dtype == "bfloat16":
        y = y.to(torch.bfloat16)
    y = y.to(x.dtype)
    if cfg.use_bias:
        y = y + params["bo"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    specs = {"scale": ParamSpec((cfg.d_model,), ("act_model",), "ones")}
    if cfg.norm_kind == "layernorm" and cfg.use_bias:
        specs["bias"] = ParamSpec((cfg.d_model,), ("act_model",), "zeros")
    return specs


def apply_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_kind == "layernorm":
        return layer_norm(x, params["scale"], params.get("bias"))
    return rms_norm(x, params["scale"])


# ---------------------------------------------------------------------------
# one block = norm -> mixer -> residual [-> norm -> ffn -> residual]
# ---------------------------------------------------------------------------

def block_specs(cfg: ModelConfig, mixer: str, ffn: str) -> Dict[str, Any]:
    check_supported(cfg)
    if mixer != "attn":
        raise ValueError(mixer)
    specs: Dict[str, Any] = {"norm1": norm_specs(cfg),
                             "mixer": attn_mod.attention_specs(cfg)}
    if ffn == "mlp":
        specs["norm2"] = norm_specs(cfg)
        specs["ffn"] = mlp_specs(cfg)
    elif ffn != "none":
        raise ValueError(ffn)
    return specs


def block_apply(params: Dict[str, Any], x: torch.Tensor,
                positions: Any, cfg: ModelConfig, ffn: str, mode: str,
                state: Any = None) -> Tuple[torch.Tensor, Any]:
    """x: [B, S, d] -> (x', new_state).  ``positions`` is [B, S] in train
    and prefill and the decode position (an int) in decode; train mode
    returns no state."""
    h = apply_norm(params["norm1"], x, cfg)
    if mode == "train":
        mixed, new_state = attn_mod.attention(params["mixer"], h, positions,
                                              cfg), None
    elif mode == "prefill":
        mixed, new_state = attn_mod.attention_prefill(params["mixer"], h,
                                                      positions, cfg)
    elif mode == "decode":
        fn = (attn_mod.decode_attention_tiered if cfg.kv_layout == "tiered"
              else attn_mod.decode_attention)
        mixed, new_state = fn(params["mixer"], h, state, positions, cfg)
    else:
        raise ValueError(mode)
    x = x + mixed
    if ffn != "none":
        x = x + mlp_apply(params["ffn"], apply_norm(params["norm2"], x, cfg),
                          cfg)
    return x, new_state


# ---------------------------------------------------------------------------
# the layer stack
# ---------------------------------------------------------------------------

def stack_specs(cfg: ModelConfig) -> List[Dict[str, Any]]:
    """One block spec tree per layer, following the pattern."""
    pattern = cfg.layer_pattern
    return [block_specs(cfg, *pattern[i % len(pattern)])
            for i in range(cfg.num_layers)]


# the matrix products a "dots" policy keeps (the aten ops torch.matmul
# lowers to)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _keep_dots(ctx: Any, op: Any, *args: Any, **kwargs: Any) -> Any:
    P = _ckpt.CheckpointPolicy
    return P.MUST_SAVE if op in _DOTS else P.PREFER_RECOMPUTE


def _remat_wrap(fn: Callable, policy: str) -> Callable:
    if policy == "nothing":
        return fn
    if policy == "dots":
        ctx = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                _keep_dots)
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    if policy == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    raise ValueError(f"remat_policy {policy!r}")


def run_stack(params: List[Dict[str, Any]], x: torch.Tensor, positions: Any,
              cfg: ModelConfig, mode: str,
              states: Optional[List[Any]] = None
              ) -> Tuple[torch.Tensor, List[Any]]:
    """Apply every layer in order; returns (x, per-layer states).  In
    train mode each layer's body is wrapped by ``cfg.remat_policy`` when
    gradients are being recorded, and the states are None."""
    pattern = cfg.layer_pattern
    out_states = []
    for i, p in enumerate(params):
        ffn = pattern[i % len(pattern)][1]
        if mode == "train":
            def body(x, p=p, ffn=ffn):
                return block_apply(p, x, positions, cfg, ffn, mode)[0]
            if torch.is_grad_enabled():
                body = _remat_wrap(body, cfg.remat_policy)
            x, st = body(x), None
        else:
            x, st = block_apply(p, x, positions, cfg, ffn, mode,
                                None if states is None else states[i])
        out_states.append(st)
    return x, out_states


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def _attn_state_specs(cfg: ModelConfig, batch: int, max_len: int
                      ) -> Dict[str, ParamSpec]:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kvh = ("batch", "kv_seq", "act_kv_heads", "head_dim")
    if cfg.kv_layout == "tiered":
        cc = cache_config_for(max_len, cfg.kv_tail_cap, cfg.kv_l1_comps)
        tail = ParamSpec((batch, cc.tail_cap, kv, hd),
                         ("batch", None, "act_kv_heads", "head_dim"),
                         "zeros", dtype=torch.bfloat16)
        ring = ParamSpec((cc.l1_comps, batch, cc.tail_cap, kv, hd),
                         (None, "batch", None, "act_kv_heads", "head_dim"),
                         "zeros", dtype=torch.bfloat16)
        l2 = ParamSpec((batch, cc.max_len, kv, hd), kvh, "zeros",
                       dtype=torch.bfloat16)
        specs = {"tail_k": tail, "tail_v": tail, "l1_k": ring, "l1_v": ring,
                 "l2_k": l2, "l2_v": l2}
        specs.update({c: ParamSpec((), (), "zeros", dtype=torch.int32)
                      for c in COUNTERS})
        return specs
    buf = ParamSpec((batch, max_len, kv, hd), kvh, "zeros",
                    dtype=torch.bfloat16)
    return {"k": buf, "v": buf}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> List[Dict[str, ParamSpec]]:
    """The decode-state spec tree: one attention state per layer, bf16
    buffers as the reference declares them (its serve path and this
    port's build float32 caches from the prefill instead; the port keeps
    a tiered cache's counters as host ints)."""
    check_supported(cfg)
    return [_attn_state_specs(cfg, batch, max_len)
            for _ in range(cfg.num_layers)]
