"""The FL training entry point (port of ``repro/launch/train.py``), simulation
mode: N simulated edge devices, r sampled a round, the exact rand-k and
AirComp channel, driven through ``repro_torch.fl.Trainer``; the (eps,
delta) ledger lives in the ``TrainState``. The CLI runs on the card;
``run_simulation(args, device="cpu")`` runs on the host.

  PYTHONPATH=src python -m repro_torch.launch.train --algorithm pfels \\
      --rounds 100 --epsilon 1.5 --p 0.3
  PYTHONPATH=src python -m repro_torch.launch.train --model cnn \\
      --bank streamed --clients 100000 --rounds 3 --eval-every 3

The flags, defaults and output JSON are the reference's, every channel
model, compressor and schedule included:

  PYTHONPATH=src python -m repro_torch.launch.train --channel mimo_mrc \\
      --antennas 8 --compressor top_k_ef --schedule budget --eps-floor 0.1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch import prng
from repro_torch.configs import BENCH_CNN_CIFAR, BENCH_MLP
from repro_torch.configs.base import CompressionSchedule, PFELSConfig
from repro_torch.core.channel import scaled_channel
from repro_torch.core.channels import list_channel_models
from repro_torch.core.compressors import list_compressors
from repro_torch.data import (make_federated_classification,
                              make_population_source)
from repro_torch.fl import Trainer, list_algorithms
from repro_torch.models import cnn


def run_simulation(args, device="cuda"):
    """One simulated FL run from the CLI's ``args`` namespace on
    ``device``; returns (and with ``args.out`` writes) the reference's
    JSON: config, per-evaluation history, total energy, privacy totals
    and the wall seconds."""
    model_cfg = BENCH_CNN_CIFAR if args.model == "cnn" else BENCH_MLP
    key = prng.PRNGKey(args.seed, device)
    params = cnn.init_cnn(key, model_cfg, device=device)
    d = sum(p.numel() for p in params.values())
    # the regime-scaled fading floor, specialized to the selected model
    chan = dataclasses.replace(
        scaled_channel(d), model=args.channel,
        num_antennas=args.antennas, markov_rho=args.markov_rho,
        dropout_prob=args.dropout_prob)
    cfg = PFELSConfig(
        num_clients=args.clients, clients_per_round=args.sampled,
        local_steps=args.tau, local_lr=args.lr, clip=args.clip,
        compression_ratio=args.p, epsilon=args.epsilon,
        rounds=args.rounds, momentum=args.momentum,
        algorithm=args.algorithm,
        dp_fedavg_sigma=args.dp_sigma,
        bank_backend=args.bank,
        compressor=args.compressor,
        quant_bits=args.quant_bits,
        threshold_frac=args.threshold_frac,
        error_feedback=args.error_feedback,
        transmit_clip=args.transmit_clip,
        schedule=CompressionSchedule(
            mode=args.schedule, k_end_ratio=args.k_end_ratio,
            power_end=args.power_end, eps_floor=args.eps_floor),
        channel=chan)
    image_shape = (model_cfg.in_channels, model_cfg.image_size,
                   model_cfg.image_size)
    if args.bank == "streamed" and args.dirichlet_alpha is None:
        # population scale: each cohort's data is made on demand and the
        # bank stays in host memory; no (n, samples, ...) tensor exists
        x, xt, yt = make_population_source(
            key, n_clients=cfg.num_clients, per_client=args.per_client,
            num_classes=model_cfg.num_classes, image_shape=image_shape,
            device=device)
        y = None
    else:
        x, y, xt, yt = make_federated_classification(
            key, n_clients=cfg.num_clients, per_client=args.per_client,
            num_classes=model_cfg.num_classes, image_shape=image_shape,
            alpha=args.dirichlet_alpha, device=device)
    loss_fn = lambda p, b: cnn.cnn_loss(p, model_cfg, b)
    trainer = Trainer(cfg, loss_fn, params, device=device)
    state = trainer.init(key)
    history = []
    energy_total = 0.0
    t0 = time.time()
    while int(state.round) < cfg.rounds:
        chunk = min(args.eval_every, cfg.rounds - int(state.round))
        state, m = trainer.run(state, x, y, rounds=chunk)
        energy_total += float(m["energy"].sum())
        tl, acc = trainer.evaluate(state, xt, yt)
        history.append({"round": int(state.round) - 1,
                        "train_loss": float(m["train_loss"][-1]),
                        "test_acc": acc, "energy_cum": energy_total,
                        "subcarriers": int(m["subcarriers"][-1])})
        print(f"[{cfg.algorithm}] round {int(state.round) - 1:4d} loss="
              f"{float(m['train_loss'][-1]):.3f} acc={acc:.3f} "
              f"energy={energy_total:.3e}", flush=True)
    totals = trainer.ledger_totals(state)
    out = {"config": {"algorithm": cfg.algorithm, "epsilon": cfg.epsilon,
                      "p": cfg.compression_ratio, "rounds": cfg.rounds,
                      "clients": cfg.num_clients, "d": d,
                      "channel": cfg.channel.model,
                      "compressor": cfg.compressor,
                      "schedule": cfg.schedule.mode},
           "history": history,
           "energy_total": energy_total,
           "privacy": {"per_round_eps_max": totals["eps_max_round"],
                       "basic_composition": totals["basic"],
                       "advanced_composition": totals["advanced"]},
           "wall_s": time.time() - t0}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="simulation",
                    choices=["simulation"])
    ap.add_argument("--algorithm", default="pfels",
                    choices=list_algorithms())
    ap.add_argument("--model", default="mlp", choices=["mlp", "cnn"])
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--sampled", type=int, default=16)
    ap.add_argument("--per-client", type=int, default=40)
    ap.add_argument("--tau", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--p", type=float, default=0.3)
    ap.add_argument("--epsilon", type=float, default=1.5)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--dp-sigma", type=float, default=1.0)
    ap.add_argument("--dirichlet-alpha", type=float, default=None)
    ap.add_argument("--channel", default="block_fading",
                    choices=list_channel_models(),
                    help="wireless scenario from the "
                         "repro_torch.core.channels registry (block_fading "
                         "is the paper's i.i.d. flat fading)")
    ap.add_argument("--antennas", type=int, default=4,
                    help="M receive antennas (mimo_mrc)")
    ap.add_argument("--markov-rho", type=float, default=0.9,
                    help="round-to-round gain correlation (markov_fading)")
    ap.add_argument("--dropout-prob", type=float, default=0.1,
                    help="per-round transmission dropout probability")
    ap.add_argument("--compressor", default="rand_k",
                    choices=list_compressors(),
                    help="update compressor from the "
                         "repro_torch.core.compressors registry (rand_k is "
                         "the paper's sparsifier)")
    ap.add_argument("--quant-bits", type=int, default=8,
                    help="signed quantization bits (stoch_quant)")
    ap.add_argument("--threshold-frac", type=float, default=0.1,
                    help="live-coordinate threshold as a fraction of "
                         "max|delta_hat| (threshold)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="per-client error-feedback residual memory "
                         "(forced on by carry compressors like top_k_ef)")
    ap.add_argument("--transmit-clip", type=float, default=None,
                    help="per-client l2 cap on the transmitted update")
    ap.add_argument("--schedule", default="none",
                    choices=["none", "linear", "budget"],
                    help="CompressionSchedule mode (k / power anneal; "
                         "'budget' also paces the per-round epsilon)")
    ap.add_argument("--k-end-ratio", type=float, default=1.0,
                    help="final live fraction of the k budget (schedule)")
    ap.add_argument("--power-end", type=float, default=1.0,
                    help="final power-limit multiplier (schedule)")
    ap.add_argument("--eps-floor", type=float, default=0.0,
                    help="per-round epsilon floor (budget schedule)")
    ap.add_argument("--bank", default="resident",
                    choices=["resident", "streamed"],
                    help="ClientBank backend: 'streamed' keeps per-client "
                         "state in host memory and makes cohort data on "
                         "demand, so --clients can be 100000+ with device "
                         "memory independent of it")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    run_simulation(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
