"""Plain reference of the PFELS production step (PFELS as the optimizer
of one language model that is one FL client, paper Alg. 2 with the
per-tensor mask of the large-model formulation):

1. g = grad of the mean next-token loss at theta (f32);
2. Delta = -eta g min(1, C1 / ||g||);
3. the round key splits into (channel, mask, noise) keys; the channel key
   into (gain, power) keys: |h| = clip(gain_mean Exp(1)), the power limit
   P from an SNR drawn uniformly in dB, P = SNR d sigma0^2;
4. beta = min(|h| sqrt(d P) / (C1 eta tau sqrt(k)), eps / C2) with
   k = round(p d) and C2 of the paper's Theorem 3;
5. for each leaf, in pytree order, one Bernoulli(p) mask A and one
   standard normal z, each from its own key of split(mask key, leaves)
   and split(noise key, leaves): theta += (beta A Delta + sigma0 A z) /
   (r beta), rounded to the leaf's storage dtype;
6. energy = (beta / |h|)^2 ||A Delta||^2.

Inputs come from ``bench/inputs.py`` and the seed, never from the
program."""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from bench import inputs
from bench.reference import hybrid_lm, threefry


def c2(eta, tau, c1, r, n, delta, sigma0) -> float:
    """Theorem 3: 2 sqrt(2) eta tau C1 r sqrt(ln(1.25 r / (N delta))) /
    (N sigma0)."""
    return (2.0 * math.sqrt(2.0) * eta * tau * c1 * r
            * math.sqrt(math.log(1.25 * r / (n * delta)))) / (n * sigma0)


def channel(key, pf, d: int, device):
    """(|h|, beta) of a one-client round."""
    ch = pf["channel"]
    kg, kp = threefry.split(key)
    gain = threefry.exponential(kg, (1,), device).double() * ch["gain_mean"]
    gain = gain.clamp(ch["gain_clip"][0], ch["gain_clip"][1])
    snr_db = threefry.uniform_range(kp, (1,), ch["snr_db_range"][0],
                                    ch["snr_db_range"][1], device).double()
    power = 10.0 ** (snr_db / 10.0) * d * ch["noise_std"] ** 2
    k = max(int(round(pf["compression_ratio"] * d)), 1)
    eta, tau, c1 = pf["local_lr"], pf["local_steps"], pf["clip"]
    cap_power = gain * torch.sqrt(d * power) / (c1 * eta * tau
                                                * math.sqrt(k))
    cap_priv = pf["epsilon"] / c2(eta, tau, c1, pf["clients_per_round"],
                                  pf["num_clients"], pf["delta"],
                                  ch["noise_std"])
    return float(gain[0]), min(float(cap_power[0]), cap_priv)


def run(m, pf, seed: int, traffic, n_steps: int, device,
        precision: str = "f32", half_batch: bool = False):
    """``n_steps`` reference steps from the seed's weights on the seed's
    batches 0.. and keys 0... Returns (theta after the steps {path:
    tensor in its storage dtype}, per-step {loss, grad_norm, beta,
    energy}, each leaf's gradient norm at step 1). ``half_batch`` trains
    on the first half of each batch: the fault of a step that drops half
    of it."""
    if pf["local_steps"] != 1 or pf["clients_per_round"] != 1:
        raise ValueError("the reference step covers tau = 1, one client")
    specs = hybrid_lm.param_specs(m)
    paths = [s[0] for s in specs]
    d = sum(math.prod(s[1]) for s in specs)
    theta = inputs.make_weights(specs, seed, device)
    b, s = traffic["batch"], traffic["seq"]
    sigma0 = pf["channel"]["noise_std"]
    p = pf["compression_ratio"]
    records: List[Dict[str, float]] = []
    leaf_gn: List[float] = []
    for i in range(n_steps):
        tok = inputs.token_batch(seed, i, b, s + 1, m["vocab_size"], device)
        if half_batch:
            tok = tok[: b // 2]
        leaves = {q: theta[q].detach().float().requires_grad_(True)
                  for q in paths}
        loss = hybrid_lm.loss(hybrid_lm.nest(leaves), m, tok[:, :-1],
                              tok[:, 1:], precision)
        grads = torch.autograd.grad(loss, [leaves[q] for q in paths])
        del leaves
        norms = [float(torch.linalg.vector_norm(g.double())) for g in grads]
        if i == 0:
            leaf_gn = norms
        gnorm = math.sqrt(sum(x * x for x in norms))
        scale = min(1.0, pf["clip"] / max(gnorm, 1e-12))
        kc, km, kn = threefry.split(inputs.key_words(seed, i), 3)
        gain, beta = channel(kc, pf, d, device)
        mkeys = threefry.split(km, len(paths))
        nkeys = threefry.split(kn, len(paths))
        sq = 0.0
        for j, q in enumerate(paths):
            g = grads[j]
            shape = tuple(g.shape)
            mask = threefry.bernoulli(mkeys[j], p, shape, device).double()
            am = (-pf["local_lr"] * scale) * g.double() * mask
            sq += float(torch.sum(am * am))
            z = threefry.normal(nkeys[j], shape, device).double()
            delta = (am * beta + sigma0 * mask * z) / beta
            if pf["unbiased_rescale"]:
                delta = delta / p
            theta[q] = (theta[q].double() + delta).to(theta[q].dtype)
            del mask, am, z, delta
        del grads
        records.append({"loss": float(loss.detach()), "grad_norm": gnorm,
                        "beta": beta,
                        "energy": (beta / gain) ** 2 * sq})
    return theta, records, leaf_gn
