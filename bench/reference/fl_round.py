"""Plain reference of one PFELS round of the paper's Alg. 2 on its
ResNet-18 (paper §8.1; the round as the PFELS paper, arXiv:2304.07460,
sets it out), in f32:

1. the round key splits into 7 lanes (selection, client training, gains,
   support, channel noise, bank, CSI);
2. r of N clients without replacement (the first r of a permutation);
3. each client: tau steps, each on a minibatch of ``batch`` rows drawn
   with replacement from its data, of momentum SGD with the stochastic
   gradient clipped to C1; Delta_i = theta_i - theta;
4. |h_i| = clip(gain_mean Exp(1)); the support omega: the first k of a
   permutation of the d coordinates, k = round(p d);
5. beta = min(min_i |h_i| sqrt(d P_i) / (C1 eta tau sqrt(k)), eps / C2);
6. s_i = min(1, C_tx / ||Delta_i||); y = sum_i beta s_i A Delta_i +
   sigma0 z on omega; theta += A^T y / (r beta);
7. energy = sum_i (beta / |h_i|)^2 s_i^2 ||A Delta_i||^2.

``numerics="tf32"`` rounds the operands of every convolution and product
to TF32 (10 mantissa bits): the control."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from bench.reference import threefry
from bench.reference.pfels_step import c2

LANES = 7
SELECTION, CLIENT_TRAIN, GAINS, SUPPORT, NOISE = 0, 1, 2, 3, 4


def widths(m):
    return [max(int(c * m["width_mult"]), 8) for c in (64, 128, 256, 512)]


def _stride(si, bi):
    return 2 if (si > 0 and bi == 0) else 1


def _order(name: str):
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in name.split("."))


def param_specs(m):
    """(name, shape, dtype, init) of every leaf in flat order (names
    split at dots, indices numerically, keys as strings), the order the
    support indexes: He-normal convolutions, the head N(0, 1/fan_in), a
    zero bias."""
    w = widths(m)
    out = {"stem": (w[0], m["in_channels"], 3, 3)}
    cin = w[0]
    for si, cout in enumerate(w):
        for bi in range(2):
            pre = f"stages.{si}.{bi}."
            out[pre + "c1"] = (cout, cin, 3, 3)
            out[pre + "c2"] = (cout, cout, 3, 3)
            if _stride(si, bi) != 1 or cin != cout:
                out[pre + "proj"] = (cout, cin, 1, 1)
            cin = cout
    specs = [(n, s, "float32",
              ("normal", math.sqrt(2.0 / (s[1] * s[2] * s[3]))))
             for n, s in out.items()]
    specs.append(("out.w", (cin, m["num_classes"]), "float32",
                  ("normal", math.sqrt(1.0 / cin))))
    specs.append(("out.b", (m["num_classes"],), "float32", ("zeros",)))
    return sorted(specs, key=lambda s: _order(s[0]))


def _tf32(t):
    """t rounded to TF32 (10 mantissa bits, to nearest)."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


class _RoundTf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _tf32(t)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def _same(x, w, stride, q):
    """XLA's SAME convolution (NCHW, OIHW): padding total (ceil(n/s) - 1)
    s + k - n, the odd pixel at the end."""
    k = w.shape[-1]
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        tot = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [tot // 2, tot - tot // 2]
    return F.conv2d(F.pad(q(x), pads), q(w), stride=stride)


def forward(p, m, x, numerics="f32"):
    q = _RoundTf32.apply if numerics == "tf32" else (lambda t: t)
    x = torch.relu(_same(x, p["stem"], 1, q))
    for si in range(4):
        for bi in range(2):
            pre = f"stages.{si}.{bi}."
            s = _stride(si, bi)
            h = torch.relu(_same(x, p[pre + "c1"], s, q))
            h = _same(h, p[pre + "c2"], 1, q)
            sc = _same(x, p[pre + "proj"], s, q) if pre + "proj" in p else x
            x = torch.relu(h + sc)
    x = x.mean(dim=(2, 3))
    return q(x) @ q(p["out.w"]) + p["out.b"]


def local_train(theta, m, pf, x, y, key, numerics, half_batch):
    """tau clipped momentum-SGD steps of one client: (Delta flat, the
    minibatch losses)."""
    names = list(theta)
    p = {n: t.clone() for n, t in theta.items()}
    v = {n: torch.zeros_like(t) for n, t in theta.items()}
    losses = []
    for k in threefry.split(key, pf["local_steps"]):
        idx = threefry.randint(k, (pf["batch_size"],), 0, x.shape[0],
                               x.device)
        if half_batch:
            idx = idx[: pf["batch_size"] // 2]
        leaves = {n: p[n].requires_grad_(True) for n in names}
        logits = forward(leaves, m, x[idx], numerics)
        loss = F.cross_entropy(logits, y[idx])
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        norm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                             for g in grads))
        scale = min(1.0, pf["clip"] / max(norm, 1e-12))
        with torch.no_grad():
            for n, g in zip(names, grads):
                v[n] = pf["momentum"] * v[n] + g * scale
                p[n] = p[n].detach() - pf["local_lr"] * v[n]
        losses.append(float(loss.detach()))
    delta = torch.cat([(p[n].detach() - theta[n]).reshape(-1)
                       for n in names])
    return delta, losses


def run_round(theta, power, m, pf, x, y, key, numerics="f32",
              half_batch=False):
    """One round from ``theta`` {name: f32 tensor}; returns (new theta,
    {train_loss, update_norm, beta, energy, the minibatch losses in
    order})."""
    dev = x.device
    names = list(theta)
    flat = torch.cat([theta[n].reshape(-1) for n in names])
    d = flat.numel()
    n_cl, r = pf["num_clients"], pf["clients_per_round"]
    ch = pf["channel"]
    ks = threefry.split(key, LANES)
    sel = threefry.permutation(ks[SELECTION], n_cl, dev)[:r]
    ck = threefry.split(ks[CLIENT_TRAIN], r)
    deltas, losses = [], []
    for i in range(r):
        c = int(sel[i])
        u, loss = local_train(theta, m, pf, x[c], y[c], ck[i], numerics,
                              half_batch)
        deltas.append(u)
        losses.append(loss)
    step_losses = [v for client in losses for v in client]
    u = torch.stack(deltas).double()
    gains = (threefry.exponential(ks[GAINS], (r,), dev).double()
             * ch["gain_mean"]).clamp(*ch["gain_clip"])
    k = max(int(round(pf["compression_ratio"] * d)), 1)
    sup = threefry.permutation(ks[SUPPORT], d, dev)[:k]
    eta, tau, c1 = pf["local_lr"], pf["local_steps"], pf["clip"]
    cap = gains * torch.sqrt(d * power[sel].double()) / (
        c1 * eta * tau * math.sqrt(k))
    beta = min(float(cap.min()), pf["epsilon"] / c2(
        eta, tau, c1, r, n_cl, pf["delta"], ch["noise_std"]))
    norms = torch.linalg.vector_norm(u, dim=1)
    s = torch.clamp(pf["transmit_clip"] / norms.clamp_min(1e-12), max=1.0)
    mask = torch.zeros(d, dtype=torch.float64, device=dev)
    mask[sup] = 1.0
    z = torch.zeros(d, dtype=torch.float64, device=dev)
    z[sup] = ch["noise_std"] * threefry.normal(ks[NOISE], (k,), dev).double()
    mu = u * mask
    y_sum = beta * torch.sum(s[:, None] * mu, dim=0) + z
    energy = float(torch.sum((beta / gains) ** 2 * s ** 2
                             * torch.sum(mu * mu, dim=1)))
    new_flat = flat.double() + y_sum / (r * beta)
    out, o = {}, 0
    for n in names:
        size = theta[n].numel()
        out[n] = new_flat[o:o + size].float().reshape(theta[n].shape)
        o += size
    return out, {"train_loss": sum(step_losses) / len(step_losses),
                 "update_norm": float(norms.mean()), "beta": beta,
                 "energy": energy, "step_losses": step_losses}


def power_limits(key, pf, d, device):
    """(N,) P_i from an SNR drawn uniformly in dB a device."""
    ch = pf["channel"]
    snr = threefry.uniform_range(key, (pf["num_clients"],),
                                 ch["snr_db_range"][0], ch["snr_db_range"][1],
                                 device).double()
    return 10.0 ** (snr / 10.0) * d * ch["noise_std"] ** 2


def run(theta, m, pf, x, y, key0, n_rounds, numerics="f32",
        half_batch=False) -> Tuple[Dict, List[Dict[str, float]]]:
    """``n_rounds`` rounds from the state a run starts from ``key0``: the
    power limits drawn from ``key0``, round t's key the run stream
    ``fold_in(key0, 0x5047)`` folded with 1 t times."""
    d = sum(t.numel() for t in theta.values())
    power = power_limits(key0, pf, d, x.device)
    key = threefry.fold_in(key0, 0x5047)
    records = []
    for _ in range(n_rounds):
        theta, rec = run_round(theta, power, m, pf, x, y, key, numerics,
                               half_batch)
        records.append(rec)
        key = threefry.fold_in(key, 1)
    return theta, records


def leaf_grad_norms(theta, m, x, y) -> List[float]:
    """Each leaf's gradient norm on one client's data: the rule that
    leaves out of the change the leaves that move by round-off alone."""
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in theta.items()}
    loss = F.cross_entropy(forward(leaves, m, x), y)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return [float(torch.linalg.vector_norm(g.double())) for g in grads]
