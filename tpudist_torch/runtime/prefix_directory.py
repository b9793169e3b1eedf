"""Router-side fleet-global prefix directory
(counterpart of :mod:`tpudist.runtime.prefix_directory`).

Each replica publishes a prefix summary at ``{ns}/prefix/{rid}``
(checksummed frame, kind="prefix"): the opaque client-stamped affinity
hashes it recently admitted plus — since the tiered-KV
subsystem — the rolling CHAIN hashes resident in its HBM prefix cache
and host spill tier, its KV block size, its weights version, and a
wall-clock publish stamp.  The :class:`PrefixDirectory` is the router's
read side: one refresh per poll, shared by every dispatch decision.

Two lookups come out of it:

* :meth:`affinity` — the opaque-hash map ``_pick`` uses to sort
  prefix-hit candidates first (the affinity steer's semantics, now with
  a staleness bound).
* :meth:`best_owner` — content-based coverage: given a request's raw
  prompt, which replica's resident chain (HBM ∪ tier) covers the
  longest leading block run?  This is what triggers a pull-mode KV
  export when the covering replica is not dispatchable — the request
  lands elsewhere WITH the owner's pages instead of re-prefilling.

Staleness: a summary is advisory, so a dead-but-registered replica must
not keep attracting affinity traffic through its last publish.  Any
summary older than ``TPUDIST_PREFIX_SUMMARY_TTL_S`` (wall-clock ``at``
stamp; legacy summaries without a stamp are treated as fresh for
compatibility) is skipped and counted at ``router/prefix_stale_skips``
— the same publish-age discipline the health monitor applies to
metrics.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

from tpudist_torch import obs
from tpudist_torch.runtime import wire
from tpudist_torch.utils.logging import get_logger

log = get_logger(__name__)

__all__ = ["PrefixDirectory", "summary_ttl_from_env",
           "DEFAULT_SUMMARY_TTL_S"]

DEFAULT_SUMMARY_TTL_S = 15.0


def summary_ttl_from_env(default: float = DEFAULT_SUMMARY_TTL_S) -> float:
    """Prefix-summary staleness bound from
    ``TPUDIST_PREFIX_SUMMARY_TTL_S``; non-positive or unparsable values
    fall back to the default (the bound is a correctness-adjacent
    safety net, never disabled)."""
    raw = os.environ.get("TPUDIST_PREFIX_SUMMARY_TTL_S")
    if raw is None:
        return float(default)
    try:
        ttl = float(raw)
    except ValueError:
        return float(default)
    return ttl if ttl > 0 else float(default)


class PrefixDirectory:
    """One router's view of every replica's published prefix summary.

    :meth:`refresh` re-reads the summaries once per poll; the lookup
    methods then run against the in-memory snapshot.  Everything here
    is advisory — corrupt, missing, or stale summaries degrade to
    no-affinity / no-pull, never to a routing error.
    """

    def __init__(self, client, *, namespace: str,
                 ttl_s: float | None = None, wall=time.time) -> None:
        self.client = client
        self.ns = namespace
        self.ttl_s = (summary_ttl_from_env() if ttl_s is None
                      else float(ttl_s))
        self._wall = wall
        # rid -> decoded summary: {"hashes": set, "chains": set,
        #   "block_size": int|None, "version": int|None, "at": float}
        self._summaries: dict[str, dict] = {}
        # per-refresh chain memo: (prompt bytes, block_size) -> chain —
        # best_owner runs once per unassigned entry per poll, and every
        # entry with the same prompt/block-size shares one hash walk
        self._chain_memo: dict[tuple[bytes, int], list[int]] = {}
        self._obs_stale = obs.counter("router/prefix_stale_skips",
                                      unit="summaries")

    # -- read side ---------------------------------------------------------

    def refresh(self, rids: Sequence[str]) -> None:
        """Re-read ``{ns}/prefix/{rid}`` for every rid, applying the
        TTL.  A coord error mid-walk keeps whatever was read so far —
        the steer is advisory and a partial view still routes."""
        self._summaries = {}
        self._chain_memo = {}
        now = self._wall()
        for rid in rids:
            try:
                raw = self.client.get(f"{self.ns}/prefix/{rid}")
            except ConnectionError:
                break
            if raw is None:
                continue
            try:
                doc = wire.decode_record(raw, expect="prefix",
                                         namespace=self.ns, key=rid,
                                         replica=rid)
                at = doc.get("at")
                if at is not None and now - float(at) > self.ttl_s:
                    # dead-but-registered (or wedged) replica: its last
                    # publish must not keep attracting affinity traffic
                    self._obs_stale.inc()
                    continue
                bs = doc.get("block_size")
                self._summaries[rid] = {
                    "hashes": {int(h) for h in doc.get("hashes", [])},
                    "chains": {int(h) for h in doc.get("chains", [])},
                    "block_size": None if bs is None else int(bs),
                    "version": doc.get("version"),
                    "at": float(at) if at is not None else now,
                }
            except (wire.WireError, ValueError, TypeError):
                continue

    # -- lookups -----------------------------------------------------------

    def affinity(self, candidates: Sequence[str]) -> dict[str, set[int]]:
        """The opaque client-stamped affinity map ``Router._pick``
        consumes: ``{rid: {prefix_hash, ...}}`` for the fresh summaries
        among ``candidates``."""
        return {rid: self._summaries[rid]["hashes"]
                for rid in candidates if rid in self._summaries}

    def _chain_for(self, prompt, block_size: int) -> list[int]:
        from tpudist_torch.models.kv_pages import chain_hashes

        import numpy as np

        p = np.asarray(prompt, np.int32)
        key = (p.tobytes(), int(block_size))
        got = self._chain_memo.get(key)
        if got is None:
            got = chain_hashes(p.tolist(), int(block_size))
            self._chain_memo[key] = got
        return got

    def coverage(self, rid: str, prompt) -> int:
        """Leading full blocks of ``prompt`` resident on ``rid`` (HBM
        prefix cache or host tier), per its own advertised block size.
        0 for unknown replicas or summaries without chain data."""
        summ = self._summaries.get(rid)
        if summ is None or not summ["chains"] or not summ["block_size"]:
            return 0
        chains = summ["chains"]
        n = 0
        for h in self._chain_for(prompt, summ["block_size"]):
            if h not in chains:
                break
            n += 1
        return n

    def best_owner(self, prompt, *, live: set[str] | None = None,
                   exclude: Sequence[str] = ()) -> tuple[str | None, int]:
        """``(rid, blocks)`` of the fresh-summaried replica whose
        resident chains cover the longest leading run of ``prompt`` —
        the pull-mode export source.  ``live`` restricts to replicas
        that can still answer a pull request; ties break on rid for
        determinism."""
        best, best_cov = None, 0
        skip = set(exclude)
        for rid in sorted(self._summaries):
            if rid in skip or (live is not None and rid not in live):
                continue
            cov = self.coverage(rid, prompt)
            if cov > best_cov:
                best, best_cov = rid, cov
        return best, best_cov

    def __len__(self) -> int:
        return len(self._summaries)
