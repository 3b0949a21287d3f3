"""Batched serving driver: prefill a batch of prompts, then decode tokens,
greedily or sampled (port of ``repro/launch/serve.py``), for every family
of the reference: the dense, MoE, SSM and hybrid LLMs, Whisper (an audio
prefix of stub frame embeddings through the encoder) and the VLM (a
vision prefix of stub patch embeddings). Runs on the card unless the
caller asks for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --full --batch 8 --prompt-len 2048 --new-tokens 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-72b \\
      --full --depth 16 --batch 4 --prompt-len 2048 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --batch 4 --prompt-len 48 --new-tokens 24 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import prng
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cut_depth(cfg, depth: int):
    """The config with its stack cut to ``depth`` layers (a whole number
    of repeats of its block pattern); every width stays."""
    n_pat = len(cfg.block_pattern)
    if depth < 1 or depth % n_pat:
        raise ValueError(f"depth {depth} is not a whole number of repeats "
                         f"of {cfg.name}'s pattern of {n_pat}")
    return dataclasses.replace(cfg, n_layers=depth, n_repeat=depth // n_pat)


def _prefix(key, shape):
    """The reference's stub prefix, ``0.02 * normal(key, shape, bf16)``:
    0.02 rounded to bf16, the product rounded once."""
    z = prng.normal(key, shape, dtype=torch.bfloat16)
    return z * torch.tensor(0.02, dtype=torch.bfloat16, device=z.device)


def serve(arch: str, *, reduced: bool, batch: int, prompt_len: int,
          new_tokens: int, seed: int = 0, greedy: bool = True, window=None,
          device="cuda", depth=None, params=None):
    """Returns the reference's keys (``tokens`` (B, new_tokens),
    ``prefill_s``, ``decode_s``, ``tok_per_s``) and more: ``prompt``
    (B, prompt_len less a vision prefix), the token draw; the stub
    prefix drawn (``vision_embeds`` or ``audio_embeds``, else absent);
    ``logits``, the last decode step's (B, 1, V); ``cfg`` and
    ``params``, the config and the params served; ``drop_fraction``,
    the prefill's MoE drop fraction averaged over the MoE blocks (None
    without them). ``depth`` cuts the stack (:func:`cut_depth`);
    ``params`` serves a given tree (e.g. one carried across by
    ``convert``) instead of the seed's random init. Sampling
    (``greedy=False``) draws each token as the reference does: the root
    key split once more a step, and a categorical draw over the padded
    vocabulary from the second half. Times are host clock around work
    that ends in a device synchronisation."""
    device = torch.device(device)
    cfg = reduced_config(arch) if reduced else get_config(arch)
    if depth is not None:
        cfg = cut_depth(cfg, depth)
    key = prng.PRNGKey(seed, device)
    init_key, tok_key, vis_key, aud_key = prng.split(key, 4)
    if params is None:
        params = T.init_params(init_key, cfg, device=device)
    s_text = prompt_len - cfg.vision_prefix if cfg.family == "vlm" \
        else prompt_len
    toks = prng.randint(tok_key, (batch, s_text), 0, cfg.vocab_size)
    pbatch = {"tokens": toks}
    if cfg.family == "vlm":
        pbatch["vision_embeds"] = _prefix(
            vis_key, (batch, cfg.vision_prefix, cfg.d_model))
    if cfg.is_encoder_decoder:
        pbatch["audio_embeds"] = _prefix(
            aud_key, (batch, cfg.encoder_seq, cfg.d_model))

    _sync(device)
    t0 = time.perf_counter()
    aux = []
    logits, caches, enc_out = T.prefill(params, cfg, pbatch,
                                        extra_slots=new_tokens,
                                        window=window, aux=aux)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    drops = [a["drop_fraction"] for a in aux if "drop_fraction" in a]

    out_tokens = []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    t1 = time.perf_counter()
    for _ in range(new_tokens):
        out_tokens.append(tok)
        logits, caches = T.decode_step(params, cfg, tok, caches,
                                       window=window, enc_out=enc_out)
        if greedy:
            tok = torch.argmax(logits[:, -1:], dim=-1)
        else:
            key, sk = prng.split(key)
            tok = prng.categorical(sk, logits[:, -1])[:, None]
    _sync(device)
    t_decode = time.perf_counter() - t1
    out = {"tokens": torch.cat(out_tokens, dim=1), "prefill_s": t_prefill,
           "decode_s": t_decode,
           "tok_per_s": batch * new_tokens / max(t_decode, 1e-9),
           "prompt": toks, "logits": logits, "cfg": cfg, "params": params,
           "drop_fraction": (float(torch.stack(drops).mean()) if drops
                             else None)}
    out.update({k: v for k, v in pbatch.items() if k != "tokens"})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--depth", type=int, default=None,
                    help="cut the stack to this many layers")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = serve(args.arch, reduced=args.reduced, batch=args.batch,
              prompt_len=args.prompt_len, new_tokens=args.new_tokens,
              seed=args.seed, device=args.device, depth=args.depth)
    print(f"prefill {r['prefill_s']:.2f}s decode {r['decode_s']:.2f}s "
          f"({r['tok_per_s']:.1f} tok/s)")
    print("sample tokens:", r["tokens"][0][:16].tolist())


if __name__ == "__main__":
    main()
