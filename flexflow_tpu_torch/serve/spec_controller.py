"""Adaptive speculation controller: speculative decoding that never
loses to incremental decoding (the port's own copy of
``flexflow_tpu/serve/spec_controller.py``: host-side Python).

Static-depth drafting loses to plain incremental decoding once draft
acceptance drops: every round still pays ``depth`` draft forwards plus a
full verify pass while committing barely more than the bonus token. The
controller tracks observed acceptance per request, keeps an EWMA
estimate of the per-token acceptance probability ``p``, and between
blocks picks the draft depth that maximizes estimated committed tokens
per unit round cost. When even the best depth's estimate falls below the
incremental cost ratio, it parks the request in FALLBACK: the request
decodes through the same fused incremental decode block the
non-speculative path uses (token-identical: both paths emit the
verifier's greedy continuation) and re-drafts one cheap probe round
every ``probe_every`` fallback blocks so that acceptance can recover.

Cost model (in units of one verifier forward, which is what an
incremental decode step costs; both stream the weights):

* expected committed tokens per round at per-token acceptance ``p`` and
  depth ``d`` (greedy chain acceptance + bonus token):
      E(p, d) = sum_{k=0..d} p^k = (1 - p^{d+1}) / (1 - p)
* round cost: 1 verify + d draft steps, each costing ``r`` =
  draft_cost_ratio (estimated from parameter bytes):
      C(d) = 1 + d * r + overhead
* speedup estimate vs incremental = E(p, d) / C(d); the fallback
  decision is ``max_d E/C < 1``, with hysteresis margins around 1.

The chosen depth is only a BOUND handed to the engines: both fused
engines (serve/engine.py) run one max-depth loop and take a per-row
depth vector, stopping the draft at the round's deepest active row and
capping acceptance per row. Inside a block the engine also applies the
grow-on-full-accept / shrink-on-zero-accept rule per round; the host
re-anchors the vector from the cost model between blocks.

``SpecController.fallback_entries_total`` counts parks; the telemetry
hooks ``take_new_fallbacks`` and ``live_stats`` feed the
``ffsv_spec_fallback_*`` and ``ffsv_spec_acceptance_ewma`` metrics once a
scheduling tick.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.quant import quantized_nbytes

# ---------------------------------------------------------------------------
# pure cost model
# ---------------------------------------------------------------------------


def expected_tokens_per_round(p: float, depth: int) -> float:
    """E[committed tokens] for one greedy-chain round at per-token
    acceptance probability ``p`` and draft depth ``depth`` (accepted
    prefix + the verifier's bonus token): sum_{k=0..depth} p^k."""
    p = min(max(p, 0.0), 1.0)
    if p >= 1.0:
        return float(depth + 1)
    return (1.0 - p ** (depth + 1)) / (1.0 - p)


def round_cost(depth: int, draft_cost_ratio: float,
               overhead: float = 0.05) -> float:
    """One round's cost in incremental-step units: a full verify pass
    (~1 incremental step — same weight stream) + ``depth`` draft steps +
    a fixed per-round overhead (dispatch/accept bookkeeping)."""
    return 1.0 + depth * draft_cost_ratio + overhead


def speedup_estimate(p: float, depth: int, draft_cost_ratio: float,
                     overhead: float = 0.05) -> float:
    """Estimated tokens-per-round / round-cost — directly comparable to
    incremental decoding's 1.0 tokens per unit cost."""
    return (expected_tokens_per_round(p, depth)
            / round_cost(depth, draft_cost_ratio, overhead))


def best_depth(p: float, min_depth: int, max_depth: int,
               draft_cost_ratio: float,
               overhead: float = 0.05) -> Tuple[int, float]:
    """(depth maximizing the speedup estimate, that estimate). Ties
    resolve to the DEEPER depth: more tokens per round amortizes real
    per-round overheads the scalar model underestimates."""
    best_d, best_est = min_depth, -1.0
    for d in range(min_depth, max_depth + 1):
        est = speedup_estimate(p, d, draft_cost_ratio, overhead)
        if est >= best_est:
            best_d, best_est = d, est
    return best_d, best_est


def estimate_draft_cost_ratio(llm, ssms: Sequence) -> float:
    """Per-draft-step cost relative to one verifier step, summed over the
    draft models: decode forwards are weight-stream bound, so parameter
    BYTES (which already fold in quantization) are the honest proxy.
    Floored so a degenerate tiny draft still charges the per-step
    dispatch work inside the fused loop."""

    def pbytes(m) -> int:
        # payload + scale for a quantized leaf: what a forward reads; a
        # leaf a draft shares with its verifier still costs the draft its
        # read. Under a mesh, the sum over the ranks: every rank gets the
        # same ratio, so their controllers decide alike
        n = quantized_nbytes(m.params)
        mesh = getattr(m, "mesh", None)
        if mesh is None or mesh.device_mesh is None:
            return n
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(n)], dtype=torch.float64)
        if dist.get_backend() == "nccl":
            t = t.to(m.device)
        dist.all_reduce(t)
        return int(t.item())

    denom = max(1, pbytes(llm))
    return max(0.02, sum(pbytes(s) for s in ssms) / denom)


# ---------------------------------------------------------------------------
# pure per-request state machine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ControllerPolicy:
    """Resolved policy knobs (GenerationConfig supplies the user-facing
    fields; RequestManager resolves engine depth / cost ratio)."""

    min_depth: int = 1
    max_depth: int = 8
    ewma_alpha: float = 0.4
    draft_cost_ratio: float = 0.2
    overhead: float = 0.05
    fallback_margin: float = 0.95     # park below this estimated speedup
    recover_margin: float = 1.05      # un-park above this (hysteresis)
    probe_every: int = 4              # fallback blocks between probe rounds
    init_acceptance: float = 0.75


@dataclasses.dataclass(frozen=True)
class ReqState:
    """Per-request controller state. Immutable: every transition is a
    pure function, so policies are testable as data in, data out."""

    acceptance: float                  # EWMA of per-token acceptance prob
    depth: int                         # depth bound for the next block
    fallback: bool = False
    fallback_blocks: int = 0           # blocks since entering fallback
    fallback_entries: int = 0          # times this request fell back


def initial_state(policy: ControllerPolicy) -> ReqState:
    d, est = best_depth(policy.init_acceptance, policy.min_depth,
                        policy.max_depth, policy.draft_cost_ratio,
                        policy.overhead)
    fb = est < policy.fallback_margin
    return ReqState(acceptance=policy.init_acceptance, depth=d, fallback=fb,
                    fallback_entries=int(fb))


def observe_round(state: ReqState, depth_used: int, n_acc: int,
                  policy: ControllerPolicy) -> ReqState:
    """Fold one observed speculation round into the state: ``n_acc`` of
    ``depth_used`` drafted tokens matched the verifier. The per-round
    acceptance sample is n/(n+1) when the chain broke (n successes, one
    failure) and 1.0 on a full accept — the standard truncated-geometric
    estimator. Mode re-evaluates against the cost model with hysteresis."""
    depth_used = max(1, depth_used)
    n_acc = min(max(n_acc, 0), depth_used)
    sample = 1.0 if n_acc >= depth_used else n_acc / (n_acc + 1.0)
    a = policy.ewma_alpha
    p = (1 - a) * state.acceptance + a * sample
    d, est = best_depth(p, policy.min_depth, policy.max_depth,
                        policy.draft_cost_ratio, policy.overhead)
    if state.fallback:
        # recovery needs the estimate clearly above break-even
        if est > policy.recover_margin:
            return ReqState(acceptance=p, depth=d, fallback=False,
                            fallback_entries=state.fallback_entries)
        return dataclasses.replace(state, acceptance=p, depth=d,
                                   fallback_blocks=0)
    if est < policy.fallback_margin:
        return ReqState(acceptance=p, depth=d, fallback=True,
                        fallback_entries=state.fallback_entries + 1)
    return dataclasses.replace(state, acceptance=p, depth=d)


def note_fallback_block(state: ReqState) -> ReqState:
    """One incremental block served while parked in fallback."""
    return dataclasses.replace(state,
                               fallback_blocks=state.fallback_blocks + 1)


def probe_due(state: ReqState, policy: ControllerPolicy) -> bool:
    """A parked request re-drafts one cheap probe block every
    ``probe_every`` fallback blocks so acceptance can recover."""
    return state.fallback and state.fallback_blocks >= policy.probe_every


def depth_schedule(trace: Iterable[Tuple[int, int]],
                   policy: ControllerPolicy) -> List[ReqState]:
    """Replay an acceptance trace [(depth_used, n_acc), ...] through the
    state machine and return the state after each round — the pure
    "acceptance trace -> depth schedule" view the tests pin."""
    state = initial_state(policy)
    out = []
    for depth_used, n_acc in trace:
        state = observe_round(state, depth_used, n_acc, policy)
        out.append(state)
    return out


# ---------------------------------------------------------------------------
# host-side manager (RequestManager holds one per generation loop)
# ---------------------------------------------------------------------------


class SpecController:
    """Per-request adaptive speculation state for one serving loop.

    The RequestManager asks three questions per scheduling tick —
    ``wants_draft`` (speculate or serve incrementally this tick, probes
    included), ``depth_for`` (the depth bound to hand the engine), and
    after each fused block reports what actually happened via
    ``observe_block`` / ``note_fallback_block``.
    """

    def __init__(self, policy: ControllerPolicy):
        self.policy = policy
        self.states: Dict[int, ReqState] = {}
        self.fallback_entries_total = 0
        self._reported_fallbacks = 0

    @classmethod
    def from_generation_config(cls, gc, llm, ssms: Sequence,
                               engine_depth: int,
                               beam_width: int = 1) -> "SpecController":
        """A beam draft stages ``beam_width`` nodes a level, so its
        estimated cost per drafted token scales with the width."""
        ratio = gc.spec_draft_cost_ratio or (
            estimate_draft_cost_ratio(llm, ssms) * max(1, beam_width))
        policy = ControllerPolicy(
            min_depth=max(1, min(gc.min_spec_depth, engine_depth)),
            max_depth=engine_depth,
            ewma_alpha=gc.spec_ewma_alpha,
            draft_cost_ratio=ratio,
            fallback_margin=gc.spec_fallback_margin,
            recover_margin=gc.spec_recover_margin,
            probe_every=gc.spec_probe_every)
        return cls(policy)

    def _state(self, guid: int) -> ReqState:
        st = self.states.get(guid)
        if st is None:
            st = self.states[guid] = initial_state(self.policy)
            # a cost model that rejects speculation from the first token
            # (e.g. a draft as large as its verifier) counts as a
            # fallback entry too
            self.fallback_entries_total += st.fallback_entries
        return st

    def take_new_fallbacks(self) -> int:
        """Fallback entries since the last call (telemetry counter feed)."""
        n = self.fallback_entries_total - self._reported_fallbacks
        self._reported_fallbacks = self.fallback_entries_total
        return n

    def wants_draft(self, guid: int) -> bool:
        st = self._state(guid)
        return (not st.fallback) or probe_due(st, self.policy)

    def depth_for(self, guid: int) -> int:
        return self._state(guid).depth

    def in_fallback(self, guid: int) -> bool:
        return self._state(guid).fallback

    def observe_block(self, guid: int,
                      rounds: Iterable[Tuple[int, int]]) -> None:
        """Fold a fused block's per-round (depth_used, n_acc) pairs in.
        An empty probe block (engine masked every round) still counts as
        a zero-evidence probe: restart the probe clock so the request
        doesn't probe every single tick."""
        st = self._state(guid)
        before = st.fallback_entries
        any_round = False
        for depth_used, n_acc in rounds:
            st = observe_round(st, depth_used, n_acc, self.policy)
            any_round = True
        if not any_round and st.fallback:
            st = dataclasses.replace(st, fallback_blocks=0)
        self.fallback_entries_total += st.fallback_entries - before
        self.states[guid] = st

    def note_fallback_block(self, guid: int) -> None:
        self.states[guid] = note_fallback_block(self._state(guid))

    def drop(self, guid: int) -> None:
        self.states.pop(guid, None)

    # -- telemetry snapshot -------------------------------------------------
    def live_stats(self, guids: Optional[Iterable[int]] = None) -> dict:
        states = ([self.states[g] for g in guids if g in self.states]
                  if guids is not None else list(self.states.values()))
        if not states:
            return {"ewma_mean": None, "n_fallback": 0}
        return {
            "ewma_mean": sum(s.acceptance for s in states) / len(states),
            "n_fallback": sum(1 for s in states if s.fallback),
        }
