"""Federated LLM training with PFELS as the distributed optimizer
(production mode, DESIGN.md §3), through the PyTorch/CUDA port alone: a
reduced transformer from the assigned pool trains on synthetic LM data
for a few hundred steps under the PFELS transform (clip -> rand_k mask ->
power scale -> channel noise). On a GPU the gradient clip runs the
hand-written ``clip_norm`` kernel; on the CPU its plain version.

  PYTHONPATH=src python examples/llm_finetune_fl_torch.py \\
      --arch phi3-mini-3.8b --steps 200
  PYTHONPATH=src python examples/llm_finetune_fl_torch.py --device cpu \\
      --steps 20
"""
import argparse
import time

import torch

from repro_torch import checkpoint, prng
from repro_torch.configs import PFELSConfig, reduced_config
from repro_torch.core.channel import scaled_channel
from repro_torch.data import make_lm_sequences
from repro_torch.launch.steps import make_pfels_train_step
from repro_torch.models import transformer as T


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--epsilon", type=float, default=4.0)
    ap.add_argument("--p", type=float, default=0.5)
    ap.add_argument("--tau", type=int, default=1,
                    help="local SGD steps per round (Alg. 2); must divide"
                         " --batch")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; runs the CUDA kernels) or cpu "
                         "(runs their plain torch versions)")
    args = ap.parse_args()

    cfg = reduced_config(args.arch)
    key = prng.PRNGKey(0, device=args.device)
    params = T.init_params(key, cfg, device=args.device)
    d = T.param_count(params)
    print(f"arch={cfg.name} params={d/1e6:.2f}M (~100M-scale pool variant) "
          f"device={args.device}")

    data = make_lm_sequences(key, n_seqs=512, seq_len=args.seq + 1,
                             vocab=cfg.vocab_size)
    # fading floor scaled to the paper's regime at reduced d
    tau = args.tau
    if args.batch % tau != 0:
        tau = 1
    pfels = PFELSConfig(num_clients=1000, clients_per_round=1,
                        compression_ratio=args.p, epsilon=args.epsilon,
                        local_lr=0.1, local_steps=tau,
                        channel=scaled_channel(d))
    step = make_pfels_train_step(cfg, pfels, d)

    p = params
    t0 = time.time()
    for i in range(args.steps):
        k = prng.fold_in(key, i)
        idx = prng.randint(k, (args.batch,), 0, data.shape[0])
        seqs = data[idx].long()
        batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
        p, m = step(p, batch, k)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.3f} "
                  f"beta={float(m['beta']):.2f} "
                  f"gnorm={float(m['grad_norm']):.3f}")
    if args.device != "cpu":
        torch.cuda.synchronize()
    print(f"{args.steps} steps in {time.time()-t0:.1f}s")
    if args.ckpt:
        checkpoint.save(args.ckpt, p, meta={"arch": cfg.name,
                                            "steps": args.steps})
        print("saved", args.ckpt)


if __name__ == "__main__":
    main()
