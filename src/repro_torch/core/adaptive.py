"""Adaptive fusion-weight control (paper Sec. VI "Advanced joint
optimization"), port of `repro.core.adaptive`.

1. `AdaptiveSonarRouter` — the scalar feedback controller: one beta in
   [beta_min, beta_max] nudged by the outcome stream (failures push it up
   multiplicatively, SLO soft-misses at half that pressure, healthy
   stretches walk it back toward the configured target).

2. **SONAR-ADAPT** — the weight vector w = [alpha, beta, gamma, delta]
   held in an `AdaptState` of tensors and updated by exponentiated-gradient
   (EG) steps on the shaped reward.  The update is a handful of tensor ops
   over a fixed-size feedback bucket; the batched and sharded engines run
   it on their own device just before a route and feed the resulting [4]
   weight tensor to the fused kernels as live weights, with no host sync.

Update rule:

    r      = 0                      if the call failed
           = min(slo_ms / lat, 1)   otherwise (1 inside the SLO)
    g      = mean_valid[(r - baseline) * f]          f = [C, N, -U, -R]
    w     <- clip(w * exp(lr * g), w_min, w_max)
    baseline <- rho * baseline + (1 - rho) * mean_valid[r]

With lr = 0 the update is the bitwise identity (x * exp(0) = x and the
clip is a no-op for in-range weights): SONAR-ADAPT then *is* the
hand-tuned variant whose operands it is given.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import routing
from repro_torch.core.qos import load_penalty, rtt_penalty
from repro_torch.core.routing import Decision, RoutingConfig, SonarGeoRouter, SonarRouter

# Fixed feedback-bucket width: outcomes are padded (valid-masked) to it, so
# every update has the same shape.
FEEDBACK_BUCKET = 64


# ---------------------------------------------------------------------------
# Scalar feedback controller
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdaptiveConfig:
    target_alpha: float = 0.5        # semantic weight the controller relaxes to
    beta_min: float = 0.2
    beta_max: float = 0.9
    failure_gain: float = 1.5        # multiplicative beta bump on a failure
    soft_gain: Optional[float] = None  # on an SLO miss; None = half pressure,
                                       # i.e. 1 + (failure_gain - 1) / 2
    recovery: float = 0.02           # additive beta step per healthy pick
    latency_slo_ms: float = 200.0

    @property
    def effective_soft_gain(self) -> float:
        if self.soft_gain is not None:
            return self.soft_gain
        return 1.0 + 0.5 * (self.failure_gain - 1.0)

    @property
    def target_beta(self) -> float:
        """The recovery target, clamped into the controller's range."""
        return float(np.clip(1.0 - self.target_alpha, self.beta_min, self.beta_max))


class AdaptiveSonarRouter:
    """SONAR with outcome-feedback weight adaptation."""

    def __init__(self, servers: Sequence, cfg: RoutingConfig = RoutingConfig(),
                 adapt: AdaptiveConfig = AdaptiveConfig()):
        self.adapt = adapt
        self.base_cfg = cfg
        # start at the recovery target so beta never begins out of range
        self.beta = adapt.target_beta
        self._router = SonarRouter(servers, cfg)
        self.name = "AdaptiveSONAR"
        self.history: list = []

    @property
    def cfg(self) -> RoutingConfig:
        return dataclasses.replace(self.base_cfg, alpha=1.0 - self.beta, beta=self.beta)

    @property
    def index(self):
        return self._router.index

    def select(
        self,
        query: str,
        latency_hist: Optional[np.ndarray] = None,
        server_load: Optional[np.ndarray] = None,
        telemetry_age_s: Optional[np.ndarray] = None,
        failed_mask: Optional[np.ndarray] = None,
        client_rtt_ms: Optional[np.ndarray] = None,
        audit=None,
    ) -> Decision:
        self._router.cfg = self.cfg
        return self._router.select(
            query, latency_hist, server_load, telemetry_age_s=telemetry_age_s,
            failed_mask=failed_mask, client_rtt_ms=client_rtt_ms, audit=audit,
        )

    def observe(self, latency_ms: float, online: bool):
        a = self.adapt
        if not online:
            self.beta = min(self.beta * a.failure_gain, a.beta_max)
        elif latency_ms > a.latency_slo_ms:
            # soft miss: half the failure pressure by default
            self.beta = min(self.beta * a.effective_soft_gain, a.beta_max)
        else:
            # monotone one-step approach toward the clamped target: never
            # overshoots and never leaves [beta_min, beta_max]
            target = a.target_beta
            if self.beta > target:
                self.beta = max(self.beta - a.recovery, target)
            elif self.beta < target:
                self.beta = min(self.beta + a.recovery, target)
        self.history.append(self.beta)


# ---------------------------------------------------------------------------
# SONAR-ADAPT: exponentiated-gradient weight adaptation
# ---------------------------------------------------------------------------

class AdaptConfig(NamedTuple):
    """Knobs of the EG update."""

    lr: float = 0.05                 # EG step size; 0 freezes the weights
    baseline_rho: float = 0.9        # reward-EMA smoothing
    w_min: float = 0.05              # multiplicative-update floor
    w_max: float = 2.0               # and ceiling
    slo_ms: float = 500.0            # reward-shaping latency target


class AdaptState(NamedTuple):
    """The learner state, tensors on the device that routes with it."""

    weights: torch.Tensor            # f32 [4] = [alpha, beta, gamma, delta]
    baseline: torch.Tensor           # f32 []  reward EMA (advantage baseline)
    step: torch.Tensor               # i32 []  applied non-empty updates


def init_state(
    cfg: RoutingConfig = RoutingConfig(),
    acfg: AdaptConfig = AdaptConfig(),
    device=None,
) -> AdaptState:
    """Start from the hand-tuned weights of ``cfg``: with lr = 0 the
    learner therefore *is* the hand-tuned variant, forever.  The state
    lives on ``device`` (the CPU when None)."""
    w = np.asarray([cfg.alpha, cfg.beta, cfg.gamma, cfg.delta], np.float32)
    if np.any(w < acfg.w_min) or np.any(w > acfg.w_max):
        raise ValueError("initial weights must sit inside [w_min, w_max] so the zero-lr "
                         "update is the bitwise identity")
    dev = torch.device("cpu") if device is None else torch.device(device)
    return AdaptState(
        weights=torch.from_numpy(w).to(dev),
        baseline=torch.zeros((), dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def shape_reward(latency_ms: float, ok: bool, slo_ms: float) -> float:
    """Scalar reward: 0 on failure, 1 inside the SLO, partial credit
    ``slo / latency`` beyond it (host side)."""
    if not ok:
        return 0.0
    lat = max(float(latency_ms), 1e-6)
    return min(slo_ms / lat, 1.0)


def decision_feats(
    expertise: float,
    network: float,
    load_pen: float = 0.0,
    rtt_pen: float = 0.0,
) -> np.ndarray:
    """Feature vector f = [C, N, -U, -R] at the winning candidate: the
    per-weight sensitivities of the fused score S = w . f."""
    return np.asarray([expertise, network, -load_pen, -rtt_pen], np.float32)


def pad_feedback(
    rewards: Sequence[float],
    feats: Sequence[np.ndarray],
    bucket: int = FEEDBACK_BUCKET,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a variable-length outcome list to the fixed bucket with a
    validity mask (numpy; the caller moves it to the learner's device)."""
    n = min(len(rewards), bucket)
    r = np.zeros((bucket,), np.float32)
    f = np.zeros((bucket, 4), np.float32)
    v = np.zeros((bucket,), np.float32)
    if n:
        r[:n] = np.asarray(rewards[:n], np.float32)
        f[:n] = np.asarray(feats[:n], np.float32).reshape(n, 4)
        v[:n] = 1.0
    return r, f, v


def _adapt_step(
    state: AdaptState,
    rewards: torch.Tensor,           # f32 [B] shaped rewards
    feats: torch.Tensor,             # f32 [B, 4] = [C, N, -U, -R] at winner
    valid: torch.Tensor,             # f32 [B] 1 = real outcome, 0 = pad
    acfg: AdaptConfig,
) -> AdaptState:
    """One masked-mean EG step, as tensor ops on the state's device (no
    host sync).  An all-pad bucket returns the state bitwise unchanged;
    with lr = 0 so does any bucket."""
    dev = state.weights.device
    r = torch.as_tensor(rewards, dtype=torch.float32).to(dev)
    f = torch.as_tensor(feats, dtype=torch.float32).to(dev)
    v = torch.as_tensor(valid, dtype=torch.float32).to(dev)
    n = torch.sum(v)
    has = n > 0.0
    denom = torch.clamp_min(n, 1.0)
    adv = (r - state.baseline) * v                        # [B]
    g = torch.sum(adv[:, None] * f, dim=0) / denom        # [4]
    w = torch.clamp(state.weights * torch.exp(acfg.lr * g), acfg.w_min, acfg.w_max)
    mean_r = torch.sum(r * v) / denom
    baseline = acfg.baseline_rho * state.baseline + (1.0 - acfg.baseline_rho) * mean_r
    return AdaptState(
        weights=torch.where(has, w, state.weights),
        baseline=torch.where(has, baseline, state.baseline),
        step=state.step + has.to(torch.int32),
    )


def adapt_update(
    state: AdaptState,
    rewards: np.ndarray,
    feats: np.ndarray,
    valid: np.ndarray,
    acfg: AdaptConfig,
) -> AdaptState:
    """Standalone update (the scalar router and `FeedbackLearner`): the
    same `_adapt_step`, looked up on the module at call time."""
    return _adapt_step(state, rewards, feats, valid, acfg)


class FeedbackLearner:
    """An engine's SONAR-ADAPT learner: its config, its state on the
    engine's device, and the outcomes recorded since the last route."""

    def __init__(self, cfg: RoutingConfig, acfg: AdaptConfig, device=None):
        self.cfg = acfg
        self.state = init_state(cfg, acfg, device)
        self._rewards: list = []
        self._feats: list = []

    @classmethod
    def for_engine(cls, algo: str, cfg: RoutingConfig, adapt: Optional[AdaptConfig],
                   device) -> Optional["FeedbackLearner"]:
        """The learner of an engine routing ``algo``: None for a hand-tuned
        algorithm without ``adapt``; ``algo="sonar_adapt"`` implies the
        default `AdaptConfig`."""
        if algo != "sonar_adapt" and adapt is None:
            return None
        return cls(cfg, adapt if adapt is not None else AdaptConfig(), device)

    @property
    def weights(self) -> np.ndarray:
        """Live [alpha, beta, gamma, delta] (host copy)."""
        return self.state.weights.cpu().numpy().astype(np.float32)

    def observe(self, latency_ms: float, ok: bool, feats) -> None:
        """Record one completed call's outcome (host side, a cheap append)."""
        if feats is None:
            return
        self._rewards.append(shape_reward(latency_ms, ok, self.cfg.slo_ms))
        self._feats.append(np.asarray(feats, np.float32))

    def pending_weights(self) -> Optional[torch.Tensor]:
        """Fold the recorded outcomes into the state, FEEDBACK_BUCKET at a
        time as tensor ops on its device, and return the [4] weight tensor
        to route with.  None with lr == 0: the engine keeps its static
        program, byte-identical to the hand-tuned variant's."""
        if self.cfg.lr == 0.0:
            return None
        B = FEEDBACK_BUCKET
        while self._rewards:
            r, f, v = pad_feedback(self._rewards[:B], self._feats[:B], B)
            self.state = adapt_update(self.state, r, f, v, self.cfg)
            del self._rewards[:B]
            del self._feats[:B]
        return self.state.weights


def weights_cfg(cfg: RoutingConfig, state: AdaptState) -> RoutingConfig:
    """Re-derive a RoutingConfig carrying the live learned weights."""
    w = state.weights.detach().cpu().numpy().astype(np.float32)
    return dataclasses.replace(
        cfg, alpha=float(w[0]), beta=float(w[1]), gamma=float(w[2]), delta=float(w[3]),
    )


class SonarAdaptRouter(SonarGeoRouter):
    """SONAR-ADAPT: every fusion extension on, weights learned online.

    Structurally SONAR-GEO + staleness + failover, so fed exactly the
    inputs of any hand-tuned variant (and with matching weights) it
    computes the identical fusion.  The weight vector lives in an
    `AdaptState` on the CPU, updated by `_adapt_step` per observed outcome.
    """

    name = "SONAR-ADAPT"
    uses_staleness = True
    uses_failover = True

    def __init__(
        self,
        servers: Sequence,
        cfg: RoutingConfig = RoutingConfig(),
        adapt: AdaptConfig = AdaptConfig(),
    ):
        super().__init__(servers, cfg)
        self.base_cfg = cfg
        self.adapt_cfg = adapt
        self.state = init_state(cfg, adapt)
        self.last_feats: Optional[np.ndarray] = None
        self.weight_history: list = []

    @property
    def weights(self) -> np.ndarray:
        return self.state.weights.detach().cpu().numpy().astype(np.float32)

    def select(
        self,
        query: str,
        latency_hist: Optional[np.ndarray] = None,
        server_load: Optional[np.ndarray] = None,
        telemetry_age_s: Optional[np.ndarray] = None,
        failed_mask: Optional[np.ndarray] = None,
        client_rtt_ms: Optional[np.ndarray] = None,
        affinity: Optional[np.ndarray] = None,
        audit=None,
    ) -> Decision:
        if self.adapt_cfg.lr != 0.0:
            self.cfg = weights_cfg(self.base_cfg, self.state)
        d = super().select(
            query, latency_hist, server_load, telemetry_age_s=telemetry_age_s,
            failed_mask=failed_mask, client_rtt_ms=client_rtt_ms, affinity=affinity,
            audit=audit,
        )
        # stash f = [C, N, -U, -R] at the winner for the next observe()
        u = 0.0
        if self.uses_load and server_load is not None and self.cfg.gamma != 0.0:
            rho = np.asarray(server_load, np.float32)[d.server_idx]
            u = float(load_penalty(torch.tensor(rho), self.cfg.load_knee, self.cfg.load_sharp))
        r = 0.0
        if self.uses_rtt and client_rtt_ms is not None and self.cfg.delta != 0.0:
            rtt = np.asarray(client_rtt_ms, np.float32)[d.server_idx]
            r = float(rtt_penalty(torch.tensor(rtt), self.cfg.rtt_scale_ms))
        self.last_feats = decision_feats(d.expertise, d.network, u, r)
        return d

    def observe_outcome(
        self,
        latency_ms: float,
        ok: bool = True,
        feats: Optional[np.ndarray] = None,
    ) -> None:
        """Apply one EG step from a completed call's outcome."""
        if feats is None:
            feats = self.last_feats
        if feats is None or self.adapt_cfg.lr == 0.0:
            return
        reward = shape_reward(latency_ms, ok, self.adapt_cfg.slo_ms)
        r, f, v = pad_feedback([reward], [np.asarray(feats)], 1)
        self.state = adapt_update(self.state, r, f, v, self.adapt_cfg)
        self.weight_history.append(self.weights)

    def observe(self, latency_ms: float, online: bool) -> None:
        """Agent-loop feedback protocol."""
        self.observe_outcome(latency_ms, ok=online)


routing.ALGORITHMS.setdefault("sonar_adapt", SonarAdaptRouter)
