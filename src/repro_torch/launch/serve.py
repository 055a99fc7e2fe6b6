"""Serving driver: prefill + batched decode with KV caches (counterpart of
``repro/launch/serve.py``).

Random weights and a random prompt from ``--seed``, drawn by a generator
on ``--device`` (on the card, so that a full-width table's billions of
weights are not drawn by one host thread), then greedy
(``--temperature 0``) or temperature sampling, one token a decode step,
under ``torch.inference_mode()``.  Runs on ``--device`` (default
``cuda``; raises without a card, never falls back to the CPU).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

``main`` also returns what it printed, with the weights, prompt and each
step's logits, so that a caller can hold decode against ``forward``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.utils.hw import resolve_device


class _Clock:
    """CUDA events on the card (device time between two marks), the host
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, start, end) -> float:
        if self.cuda:
            end.synchronize()
            return start.elapsed_time(end)
        return (end - start) * 1e3


def _sample(logits, temperature: float, generator: torch.Generator):
    """Greedy argmax, or a draw from softmax(logits / temperature) by the
    Gumbel-max trick with ``generator``; over the last axis, so a
    multi-codebook model samples each codebook."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits.float() / temperature + gumbel, dim=-1)


def main(argv=None):
    """Returns a dict: ``tokens`` (B, gen[, C]), ``logits`` (the ``gen``
    logits they were sampled from: prefill's last, then each decode
    step's), ``prefill_ms``, ``decode_ms`` (the ``gen - 1`` decode
    steps), ``decode_ms_per_token``, ``tokens_per_s``, and the ``cfg``,
    ``params`` and ``prompt`` it served."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch)
           if args.reduced else configs.get_config(args.arch))
    cfg = cfg.replace(dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)
    max_len = args.prompt_len + args.gen
    shape = ((args.batch, args.prompt_len, cfg.num_codebooks)
             if cfg.num_codebooks > 1 else (args.batch, args.prompt_len))
    prompt = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device=dev)
    sampler = torch.Generator(device=dev).manual_seed(args.seed)

    def sample(logits):
        tok = _sample(logits, args.temperature, sampler)
        return tok[:, None] if cfg.num_codebooks <= 1 else tok[:, None, :]

    clock = _Clock(dev)
    with torch.inference_mode():
        t0 = clock.mark()
        logits, caches = M.prefill(params, {"tokens": prompt}, cfg, max_len)
        t1 = clock.mark()
        toks = sample(logits)
        generated, step_logits = [toks], [logits]
        t2 = clock.mark()
        for i in range(args.gen - 1):
            logits, caches = M.decode_step(params, toks, caches,
                                           args.prompt_len + i, cfg)
            toks = sample(logits)
            generated.append(toks)
            step_logits.append(logits)
        t3 = clock.mark()
    steps = max(args.gen - 1, 1)
    decode_ms = clock.ms(t2, t3)
    out = dict(tokens=torch.cat(generated, dim=1), logits=step_logits,
               prefill_ms=clock.ms(t0, t1), decode_ms=decode_ms,
               decode_ms_per_token=decode_ms / steps,
               tokens_per_s=args.batch * steps / (decode_ms / 1e3),
               cfg=cfg, params=params, prompt=prompt)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={dev}")
    print(f"prefill: {out['prefill_ms']:.1f} ms   "
          f"decode: {out['decode_ms_per_token']:.2f} ms/token   "
          f"{out['tokens_per_s']:.1f} tokens/s")
    print("sample token ids:", out["tokens"][0, :10].tolist())
    return out


if __name__ == "__main__":
    main()
