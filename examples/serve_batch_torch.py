"""Batched serving of a pool architecture with the PyTorch/CUDA port:
prefill a prompt batch, then decode new tokens greedily with the KV and
SSM caches. Mamba2 prefills run the hand-written ``ssd_scan`` kernel and
attention prefills the ``flash_attn`` kernel on the card.

  PYTHONPATH=src python examples/serve_batch_torch.py --full --batch 8 \\
      --prompt-len 2048 --new-tokens 64           # zamba2-2.7b on the card
  PYTHONPATH=src python examples/serve_batch_torch.py --device cpu \\
      --batch 4 --prompt-len 48 --new-tokens 24   # reduced, on the CPU
"""
import argparse

from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.launch.serve import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--full", action="store_true",
                    help="the full config (on the card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    r = serve(args.arch, reduced=not args.full, batch=args.batch,
              prompt_len=args.prompt_len, new_tokens=args.new_tokens,
              device=args.device)
    print(f"prefill {r['prefill_s']:.2f}s  decode {r['decode_s']:.2f}s  "
          f"({r['tok_per_s']:.1f} tok/s)")
    print("kernel launches:", {**ssd_kernel.LAUNCHES, **flash_kernel.LAUNCHES})
    print("sample continuation:", r["tokens"][0][:12].tolist())


if __name__ == "__main__":
    main()
