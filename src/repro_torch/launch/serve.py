"""Serving launcher: batched prefill, then greedy decode on a flat or an
LSM-tiered KV cache (the reference's ``launch/serve.py``).

``python -m repro_torch.launch.serve --arch deepseek-67b --requests 4``

A request batch goes through one prefill (K7, K8); its KV cache is then
either grown into a flat cache or bulk-loaded as the L2 component of the
paper-C3 tiered cache, and decode streams tokens through K7 and K9.  Runs
on the card unless ``--device cpu`` is given.  ``--reduced`` (the
default, as in the reference) takes the arch's reduced config;
``--no-reduced`` keeps the published widths, and ``--layers N`` cuts the
depth.  Weights are float32 from a ``torch.Generator`` seeded by
``--seed``, as the reference's launcher makes them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from ..configs.base import ModelConfig, reduced
from ..configs.registry import get_config
from ..kernels import ops as _ops
from ..kvcache.lsm_cache import cache_config_for, tiered_from_prefill
from ..models import model as M
from ..models.layers import init_params

__all__ = ["build_config", "make_params", "prefill", "prepare_cache",
           "decode", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_config(arch: str, reduce: bool = True,
                 layers: Optional[int] = None,
                 kv_layout: str = "tiered") -> ModelConfig:
    cfg = get_config(arch)
    if reduce:
        cfg = reduced(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return dataclasses.replace(cfg, kv_layout=kv_layout)


def make_params(cfg: ModelConfig, seed: int = 0) -> Dict[str, Any]:
    """float32 weights on the chosen device from a seeded generator."""
    dev = _ops.target()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init_params(M.model_specs(cfg), gen, dev, torch.float32)


def prefill(params: Dict[str, Any], cfg: ModelConfig,
            prompts: torch.Tensor) -> Dict[str, Any]:
    """One batched prefill: {"logits" [B, V], "cache" (per-layer k, v),
    "seconds" (host clock to a synchronize)}."""
    fn = M.make_prefill_fn(dataclasses.replace(cfg, kv_layout="flat"))
    dev = params["embed"].device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = fn(params, {"tokens": prompts})
    _sync(dev)
    return {"logits": logits, "cache": cache,
            "seconds": time.perf_counter() - t0}


def prepare_cache(cfg: ModelConfig, cache0: List[Dict[str, torch.Tensor]],
                  max_len: int) -> List[Dict[str, Any]]:
    """The prefill's KV caches -> decode caches for ``cfg.kv_layout``:
    bulk-loaded tiered caches (float32, as the reference's serve path), or
    flat caches grown to ``max_len`` rows."""
    if cfg.kv_layout == "tiered":
        ccfg = cache_config_for(max_len, cfg.kv_tail_cap, cfg.kv_l1_comps)
        return [tiered_from_prefill(st["k"], st["v"], ccfg, torch.float32)
                for st in cache0]
    out = []
    for st in cache0:
        grown = {}
        for name, t in st.items():
            g = t.new_zeros((t.shape[0], max_len) + tuple(t.shape[2:]))
            g[:, :t.shape[1]] = t
            grown[name] = g
        out.append(grown)
    return out


def decode(params: Dict[str, Any], cfg: ModelConfig, cache: List[Any],
           first: torch.Tensor, pos: int, steps: int,
           forced: Optional[torch.Tensor] = None,
           keep_logits: bool = False) -> Dict[str, Any]:
    """Greedy decode of ``steps`` tokens after ``first`` ([B, 1]), the
    first at position ``pos``.  With ``forced`` ([B, steps]) token t is
    forced[:, t] instead of the argmax (to feed one run's tokens to
    another).  Returns {"tokens" [B, steps + 1] with ``first``, "logits"
    (per step, if kept), "cache", "seconds"}."""
    fn = M.make_decode_fn(cfg)
    dev = params["embed"].device
    tok, out, kept = first, [first], []
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(steps):
        logits, cache = fn(params, cache, {"token": tok, "pos": pos + t})
        if keep_logits:
            kept.append(logits)
        tok = (forced[:, t:t + 1] if forced is not None
               else logits.argmax(-1)[:, None])
        out.append(tok)
    _sync(dev)
    return {"tokens": torch.cat(out, dim=1), "logits": kept, "cache": cache,
            "seconds": time.perf_counter() - t0}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="deepseek-67b")
    p.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth to N layers (widths unchanged)")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen-tokens", type=int, default=32)
    p.add_argument("--kv-layout", choices=["flat", "tiered"],
                   default="tiered")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    _ops.set_device(args.device)
    cfg = build_config(args.arch, args.reduced, args.layers, args.kv_layout)
    params = make_params(cfg, args.seed)
    B, P, T = args.requests, args.prompt_len, args.gen_tokens
    gen = torch.Generator(device=_ops.target())
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=_ops.target())
    pre = prefill(params, cfg, prompts)
    cache = prepare_cache(cfg, pre["cache"], P + T)
    first = pre["logits"].argmax(-1)[:, None]
    run = decode(params, cfg, cache, first, P, T - 1)
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"layout={args.kv_layout} device={args.device} requests={B} "
          f"prompt={P} generated={run['tokens'].shape[1]}")
    print(f"prefill: {B * P / pre['seconds']:.0f} tok/s   decode: "
          f"{B * (T - 1) / max(run['seconds'], 1e-9):.1f} tok/s "
          f"(host clock)")
    if args.kv_layout == "tiered":
        st = run["cache"][0]
        print(f"LSM cache: flushes={st['flushes']} merges={st['merges']} "
              f"per layer")
    return {"cfg": cfg, "prefill": pre, "decode": run}


if __name__ == "__main__":
    main()
