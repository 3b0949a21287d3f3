"""Batched serving driver: prefill a batch of prompts, then decode tokens
greedily (port of ``repro/launch/serve.py``). Runs on the card unless the
caller asks for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --full --batch 8 --prompt-len 2048 --new-tokens 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --batch 4 --prompt-len 48 --new-tokens 24 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, *, reduced: bool, batch: int, prompt_len: int,
          new_tokens: int, seed: int = 0, greedy: bool = True, window=None,
          device="cuda"):
    """Returns the reference's keys (``tokens`` (B, new_tokens),
    ``prefill_s``, ``decode_s``, ``tok_per_s``) and two more: ``prompt``
    (B, prompt_len), the token draw, and ``logits``, the last decode
    step's (B, 1, V). Times are host clock around work that ends in a
    device synchronisation."""
    if not greedy:
        raise NotImplementedError("sampled decoding is not ported yet: "
                                  "ROADMAP Queue 1, item 12 (serving)")
    device = torch.device(device)
    cfg = reduced_config(arch) if reduced else get_config(arch)
    key = prng.PRNGKey(seed, device)
    init_key, tok_key, _, _ = prng.split(key, 4)     # vision, audio: later
    params = T.init_params(init_key, cfg, device=device)
    toks = prng.randint(tok_key, (batch, prompt_len), 0, cfg.vocab_size)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches, _ = T.prefill(params, cfg, {"tokens": toks},
                                  extra_slots=new_tokens, window=window)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    t1 = time.perf_counter()
    for _ in range(new_tokens):
        out_tokens.append(tok)
        logits, caches = T.decode_step(params, cfg, tok, caches,
                                       window=window)
        tok = torch.argmax(logits[:, -1:], dim=-1)
    _sync(device)
    t_decode = time.perf_counter() - t1
    return {"tokens": torch.cat(out_tokens, dim=1), "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tok_per_s": batch * new_tokens / max(t_decode, 1e-9),
            "prompt": toks, "logits": logits}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = serve(args.arch, reduced=args.reduced, batch=args.batch,
              prompt_len=args.prompt_len, new_tokens=args.new_tokens,
              seed=args.seed, device=args.device)
    print(f"prefill {r['prefill_s']:.2f}s decode {r['decode_s']:.2f}s "
          f"({r['tok_per_s']:.1f} tok/s)")
    print("sample tokens:", r["tokens"][0][:16].tolist())


if __name__ == "__main__":
    main()
