"""Client-level DP accounting for PFELS (paper §6.1); port of
``repro/core/privacy.py``.

Theorem 3: with r-of-N uniform sampling without replacement and intrinsic
channel noise sigma_0, each PFELS round is (eps, delta)-DP provided
    C2 * beta <= eps,   C2 = 2*sqrt(2)*eta*tau*C1*r*sqrt(log(1.25 r/(N delta)))/(N sigma_0).

Lemma 2: l2-sensitivity of the received aggregate is psi <= beta*eta*tau*C1.

Beyond-paper additions (clearly flagged): multi-round composition via basic
and advanced composition so end-to-end (eps_T, delta_T) can be reported; the
paper itself states the per-round guarantee only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def c2_coefficient(eta: float, tau: int, c1: float, r: int, n: int,
                   delta: float, sigma0: float) -> float:
    """C2 from Eq. (21)."""
    if delta <= 0 or delta >= 1:
        raise ValueError(f"delta must be in (0,1), got {delta}")
    return (2.0 * math.sqrt(2.0) * eta * tau * c1 * r
            * math.sqrt(math.log(1.25 * r / (n * delta)))) / (n * sigma0)


def beta_privacy_cap(epsilon: float, eta: float, tau: int, c1: float,
                     r: int, n: int, delta: float, sigma0: float) -> float:
    """Largest beta satisfying the per-round DP constraint (Thm 3):
    beta <= eps / C2."""
    c2 = c2_coefficient(eta, tau, c1, r, n, delta, sigma0)
    return epsilon / c2


def round_epsilon(beta: float, eta: float, tau: int, c1: float, r: int,
                  n: int, delta: float, sigma0: float) -> float:
    """Per-round eps actually spent for a given beta (inverse of Thm 3)."""
    return c2_coefficient(eta, tau, c1, r, n, delta, sigma0) * beta


def sensitivity_bound(beta: float, eta: float, tau: int, c1: float) -> float:
    """Lemma 2: psi_Delta <= beta * eta * tau * C1."""
    return beta * eta * tau * c1


def gaussian_mechanism_sigma(sensitivity: float, epsilon: float,
                             delta: float) -> float:
    """Thm 1: sigma^2 >= 2 ln(1.25/delta) psi^2 / eps^2."""
    return sensitivity * math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def amplified_epsilon(eps0: float, r: int, n: int) -> float:
    """Thm 2 (subsampling): eps' = log(1 + (r/N)(e^eps0 - 1))."""
    return math.log(1.0 + (r / n) * (math.exp(eps0) - 1.0))


# ------------------------------------------------- composition (beyond paper)

def compose_basic(eps_round: float, delta_round: float, rounds: int):
    """(sum eps, sum delta)."""
    return eps_round * rounds, delta_round * rounds


def compose_advanced(eps_round: float, delta_round: float, rounds: int,
                     delta_prime: float = 1e-6):
    """Dwork-Roth advanced composition (Thm 3.20):
    eps_T = sqrt(2 T ln(1/delta')) eps + T eps (e^eps - 1)."""
    e = eps_round
    eps_t = math.sqrt(2.0 * rounds * math.log(1.0 / delta_prime)) * e \
        + rounds * e * (math.exp(e) - 1.0)
    return eps_t, rounds * delta_round + delta_prime


def compose_zcdp(noise_multiplier: float, rounds: int, delta: float):
    """zCDP composition (beyond paper, conservative: no subsampling
    amplification). A Gaussian mechanism with noise multiplier
    z = sigma/sensitivity satisfies rho = 1/(2 z^2) zCDP per round; T
    rounds give T*rho, converted to (eps, delta) via
    eps = rho*T + 2 sqrt(rho*T*log(1/delta))  [Bun & Steinke 2016]."""
    if noise_multiplier <= 0:
        return float("inf"), delta
    rho = rounds / (2.0 * noise_multiplier ** 2)
    return rho + 2.0 * math.sqrt(rho * math.log(1.0 / delta)), delta


def pfels_noise_multiplier(beta: float, eta: float, tau: int, c1: float,
                           sigma0: float) -> float:
    """z = sigma0 / psi with psi the Lemma-2 sensitivity."""
    psi = sensitivity_bound(beta, eta, tau, c1)
    return sigma0 / max(psi, 1e-30)


# ------------------------------------------------------ round ledger

@dataclass
class LedgerState:
    """Privacy accumulators carried in ``TrainState``: ``eps_sum`` (f32,
    basic composition), ``eps_max`` (f32, worst round, for advanced
    composition) and ``spends`` (int32, rounds charged). All-zero
    accumulators total to ``(0.0, 0.0)``."""
    eps_sum: torch.Tensor
    eps_max: torch.Tensor
    spends: torch.Tensor


def ledger_init(device="cuda") -> LedgerState:
    return LedgerState(
        eps_sum=torch.zeros((), dtype=torch.float32, device=device),
        eps_max=torch.zeros((), dtype=torch.float32, device=device),
        spends=torch.zeros((), dtype=torch.int32, device=device))


def ledger_spend(ledger: LedgerState, eps_round) -> LedgerState:
    """Charge one round's realized eps."""
    eps_round = torch.as_tensor(eps_round, dtype=torch.float32,
                                device=ledger.eps_sum.device)
    return LedgerState(eps_sum=ledger.eps_sum + eps_round,
                       eps_max=torch.maximum(ledger.eps_max, eps_round),
                       spends=ledger.spends + 1)


def ledger_totals_basic(ledger: LedgerState,
                        delta: float) -> Tuple[float, float]:
    """Host-side (eps_T, delta_T) under basic composition."""
    return float(ledger.eps_sum), delta * int(ledger.spends)


def ledger_totals_advanced(ledger: LedgerState, delta: float,
                           delta_prime: float = 1e-6) -> Tuple[float, float]:
    """Host-side (eps_T, delta_T) under Dwork-Roth advanced composition
    from the worst round's eps; (0.0, 0.0) for an empty ledger."""
    t = int(ledger.spends)
    if t == 0:
        return 0.0, 0.0
    return compose_advanced(float(ledger.eps_max), delta, t, delta_prime)


@dataclass
class PrivacyLedger:
    """Tracks per-round spends over training.

    Empty-ledger contract: both ``total_basic`` and ``total_advanced``
    return the float pair ``(0.0, 0.0)`` before any ``spend`` — nothing was
    released, so no epsilon, delta, or delta' slack is charged.
    """
    n: int
    delta: float
    eps_rounds: Optional[list] = None

    def __post_init__(self):
        if self.eps_rounds is None:
            self.eps_rounds = []

    def spend(self, eps_round: float):
        self.eps_rounds.append(float(eps_round))

    def total_basic(self):
        """(eps_T, delta_T) under basic composition (sum of rounds)."""
        return float(sum(self.eps_rounds)), self.delta * len(self.eps_rounds)

    def total_advanced(self, delta_prime: float = 1e-6):
        """(eps_T, delta_T) under Dwork-Roth advanced composition, using
        the worst round's eps (conservative)."""
        if not self.eps_rounds:
            return 0.0, 0.0
        e = max(self.eps_rounds)   # conservative: worst round
        t = len(self.eps_rounds)
        return compose_advanced(e, self.delta, t, delta_prime)
