"""Quickstart of the PyTorch/CUDA port: PFELS end-to-end on a synthetic
federated image task, through ``repro_torch`` alone.

Runs FL rounds of Algorithm 2 (simulated wireless channel, Theorem-5
power control, client-level DP accounting) with the ``Trainer`` /
``TrainState`` API; the AirComp aggregation goes through the
hand-written CUDA kernels on a GPU. Then prints the
privacy/communication/energy report.

  PYTHONPATH=src python examples/quickstart_torch.py [--rounds 200]
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --rounds 5
"""
import argparse

from repro_torch import prng
from repro_torch.configs import BENCH_CNN_CIFAR, PFELSConfig
from repro_torch.core.channel import scaled_channel
from repro_torch.data import make_federated_classification
from repro_torch.fl import Trainer
from repro_torch.models import cnn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--epsilon", type=float, default=1.5)
    ap.add_argument("--p", type=float, default=0.3)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; runs the CUDA kernels) or cpu "
                         "(runs their plain torch versions)")
    args = ap.parse_args()

    key = prng.PRNGKey(0, device=args.device)
    params = cnn.init_cnn(key, BENCH_CNN_CIFAR, device=args.device)
    x, y, xt, yt = make_federated_classification(
        key, n_clients=100, per_client=40, num_classes=10,
        image_shape=(3, 16, 16), device=args.device)
    loss_fn = lambda p, b: cnn.cnn_loss(p, BENCH_CNN_CIFAR, b)

    d = sum(p.numel() for p in params.values())
    # fading floor scaled to the paper's operating regime at reduced d
    cfg = PFELSConfig(num_clients=100, clients_per_round=8, local_steps=5,
                      local_lr=0.05, clip=1.0, compression_ratio=args.p,
                      epsilon=args.epsilon, rounds=args.rounds,
                      momentum=0.9, channel=scaled_channel(d))
    trainer = Trainer(cfg, loss_fn, params, device=args.device)
    state = trainer.init(key)
    print(f"model: {BENCH_CNN_CIFAR.name}  d={d}  "
          f"subcarriers/round={int(args.p * d)}  device={args.device}")

    energy = 0.0
    while int(state.round) < cfg.rounds:
        chunk = min(args.eval_every, cfg.rounds - int(state.round))
        state, m = trainer.run(state, x, y, rounds=chunk)
        energy += float(m["energy"].sum())
        tl, acc = trainer.evaluate(state, xt, yt)
        print(f"round {int(state.round):4d}  "
              f"loss={float(m['train_loss'][-1]):.3f}  "
              f"test_acc={acc:.3f}  beta={float(m['beta'][-1]):.2f}  "
              f"energy={energy:.3e}")

    totals = trainer.ledger_totals(state)
    (e_basic, d_basic), (e_adv, d_adv) = totals["basic"], totals["advanced"]
    print("\n--- PFELS report ---")
    print(f"per-round DP:       ({cfg.epsilon}, {cfg.resolved_delta():.1e})")
    print(f"T-round basic:      ({e_basic:.1f}, {d_basic:.1e})")
    print(f"T-round advanced:   ({e_adv:.1f}, {d_adv:.1e})")
    print(f"transmit energy:    {energy:.3e}")
    print(f"subcarriers/round:  {int(args.p * d)} of {d}")


if __name__ == "__main__":
    main()
