"""Batched serving driver: continuous-batching decode over a small model.

The production serving loop at a small size: a request queue, admission
waves that prefill queued prompts into free cache slots (one batched
prefill per wave), and a batched decode loop (one serve step advances
every slot by one token). Reports throughput and per-request latency.
The flags are the JAX package's (``repro.launch.serve``), plus
``--device``: the model runs on the CUDA card unless ``--device cpu``.
Like the reference it runs ``reduced_config`` of the architecture, on
random weights from a seeded ``torch.Generator``, and serves token-only
families (it refuses ``vlm`` and ``encdec``).

Two deliberate differences, both in how a later wave joins the live
batch (with one ``--gen-len`` for every request, all slots finish
together and every wave replaces every slot):

* the merged cache takes the admitted cache's ``index`` when every slot
  is replaced. The reference keeps the live cache's 0-d ``index`` in
  every merge, so its later waves decode from the first wave's end, past
  the cache's length (each write clamped into its last position);
* an admitted slot's first decode step takes its prefill's token. The
  reference picks the tokens to keep after admitting, when the admitted
  slots already count as decoding, so they take the token their previous
  request ended with.

So every request's tokens are ``greedy_generate``'s over its prompt.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --requests 16 --slots 4 --prompt-len 32 --gen-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --requests 5 --slots 2 --prompt-len 8 --gen-len 4

``--kg`` switches to the knowledge-graph ingestion loop instead
(:mod:`repro_torch.launch.kg_serve`).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import init_params
from repro_torch.models import get_model
from repro_torch.serve.decode import grow_cache, make_prefill, make_serve_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent decode slots (batch size)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the model's device (default: the CUDA card)")
    return ap


def merge_cache(old, new, sel: List[bool]):
    """The live cache with the slots ``sel`` taken from ``new`` (the batch
    axis is the first of size len(sel), else the second, as in the
    reference); the 0-d ``index`` is ``new``'s when every slot is
    replaced, else ``old``'s."""
    if isinstance(old, dict):
        return {k: merge_cache(v, new[k], sel) for k, v in old.items()}
    if old.dim() == 0:
        return new if all(sel) else old
    b = len(sel)
    b_axis = 0 if old.shape[0] == b else 1
    shape = [1] * old.dim()
    shape[b_axis] = b
    mask = torch.tensor(sel, device=old.device).reshape(shape)
    return torch.where(mask, new, old)


def serve_requests(cfg, params, prompts: np.ndarray, slots: int,
                   gen_len: int, device: torch.device) -> Dict:
    """Serve every prompt (rows of ``prompts``), ``gen_len`` new tokens
    each, over ``slots`` decode slots. Returns the tokens per request, the
    latencies (seconds from admission to the last token), the token count
    and the wall seconds."""
    prefill, step_fn = make_prefill(cfg), make_serve_step(cfg)
    n_slots = slots
    queue: List[int] = list(range(len(prompts)))
    done: Dict[int, List[int]] = {}
    latency: Dict[int, float] = {}
    t_admit: Dict[int, float] = {}
    slot_req = [-1] * n_slots
    remaining = [0] * n_slots
    state = {"cache": None}
    n_tokens = 0

    def admit_wave() -> Optional[torch.Tensor]:
        """Fill all free slots with queued prompts, one batched prefill."""
        free = [i for i in range(n_slots) if slot_req[i] < 0]
        if not free or not queue:
            return None
        take = [queue.pop(0) for _ in free[:len(queue)]]
        batch_tokens = np.stack([prompts[r] for r in take] +
                                [prompts[take[-1]]] * (len(free) - len(take)))
        logits, new_cache = prefill(params, {"tokens": torch.as_tensor(
            batch_tokens, dtype=torch.int32, device=device)})
        new_cache = grow_cache(new_cache, gen_len)
        if state["cache"] is None:
            state["cache"] = new_cache
        else:  # merge admitted slots into the live cache
            sel = [i in free for i in range(n_slots)]
            state["cache"] = merge_cache(state["cache"], new_cache, sel)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        now = time.perf_counter()
        for j, slot in enumerate(free[:len(take)]):
            slot_req[slot] = take[j]
            remaining[slot] = gen_len
            done[take[j]] = []
            t_admit[take[j]] = now
        return tok

    t_start = time.perf_counter()
    with torch.inference_mode():
        tok = admit_wave()
        while any(r >= 0 for r in slot_req):
            logits, state["cache"] = step_fn(params, state["cache"], tok)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            toks = tok[:, 0].cpu().numpy()
            now = time.perf_counter()
            for i in range(n_slots):
                r = slot_req[i]
                if r < 0:
                    continue
                done[r].append(int(toks[i]))
                n_tokens += 1
                remaining[i] -= 1
                if remaining[i] == 0:
                    latency[r] = now - t_admit[r]
                    slot_req[i] = -1
            if queue and any(r < 0 for r in slot_req):
                # the slots still decoding keep their token; the admitted
                # ones start from their prefill's
                keep = torch.tensor([r >= 0 for r in slot_req],
                                    device=device)
                new_tok = admit_wave()
                if new_tok is not None:
                    tok = torch.where(keep[:, None], tok, new_tok)
    return {"done": done, "latency": latency, "n_tokens": n_tokens,
            "seconds": time.perf_counter() - t_start}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--kg" in argv:   # KG-session serving loop (launch/kg_serve.py)
        from . import kg_serve
        return kg_serve.main([a for a in argv if a != "--kg"])
    args = _parser().parse_args(argv)

    cfg = reduced_config(get_config(args.arch))
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit("serve driver covers token-only families")
    dev = resolve_device(args.device)
    model = get_model(cfg.family)
    rng = np.random.default_rng(args.seed)
    params = init_params(model.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    prompts = rng.integers(0, cfg.vocab_size, (args.requests,
                                               args.prompt_len))
    run = serve_requests(cfg, params, prompts, args.slots, args.gen_len,
                         dev)
    dt, n_tokens = run["seconds"], run["n_tokens"]
    lat = sorted(run["latency"].values())
    print(f"served {len(run['done'])} requests / {n_tokens} tokens in "
          f"{dt:.2f}s ({n_tokens / dt:.1f} tok/s)")
    print(f"latency p50={lat[len(lat)//2]*1e3:.0f}ms "
          f"p99={lat[int(len(lat)*0.99)]*1e3:.0f}ms")
    if not all(len(v) == args.gen_len for v in run["done"].values()):
        raise RuntimeError("a request got another number of tokens than "
                           "--gen-len")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
