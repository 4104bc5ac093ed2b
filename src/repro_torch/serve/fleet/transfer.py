"""KV-page transfer channel between the prefill and decode pools (the
reference's ``serve/fleet/transfer.py``).

Disaggregated serving moves each admitted request's prefilled KV-cache
rows from the prefill pool to a decode replica.  That migration is a
first-class wire event here, priced like the pipeline's stage
boundaries: a point-to-point hop (Eqn. 26 ``c1 + c2*m``, no ``log2(p)``
factor) per migration, billed at static power ``B`` across the endpoint
devices of both pools while the pages move.

The channel owns the MEASURED side of the transfer account: every
``send`` adds the bundle's actual byte count (executed mode: the bytes
of the request's global cache rows, the rank's rows summed over its tp
group; modeled mode: the page table's live-token bytes at the request's
padded prefill length).  The PREDICTED side,
``telemetry.predict.kv_transfer_prediction`` from the trace's a-priori
length statistics, joins it in the ledger.

In executed mode a bundle's ``cache_rows`` stay on the device they were
prefilled on: the request's rows are a device-to-device copy out of the
prefill cache, never a host round trip.  Each transfer is traced and
counted as the reference's is (``obs/``): a ``fleet/transfer`` instant
and the transfer counters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.core.energy import FRONTIER_B_W, comm_time_us
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.telemetry.predict import (FLOAT_BYTES, kv_cache_token_bytes,
                                           kv_transfer_prediction)


@dataclass
class KVBundle:
    """One request's migration payload: the decode-side state the
    replay-last-token contract needs (``pos`` / ``last_tok``) plus, in
    executed mode, this rank's cache rows (a tree matching the engine
    cache's leaves with batch axis 1, ``prefill_len`` positions long,
    sequence-sharded over tp as the prefill left them)."""
    req: Any
    prefill_len: int              # padded prompt rows the cache holds
    pos: int
    last_tok: int
    cache_rows: Any = None        # executed mode only
    wire_bytes: float = 0.0       # measured bytes (stamped by send)
    ready_s: float = 0.0          # virtual time the transfer completes
    src_replica: int = -1


class TransferChannel:
    """Prices (and, in executed mode, carries) prefill->decode KV-page
    migrations, accumulating the measured transfer account."""

    def __init__(self, cfg, *, tp_src: int = 1, tp_dst: int = 1,
                 fits=None, B: float = FRONTIER_B_W,
                 colocated: bool = False):
        self.cfg = cfg
        self.tp_src = max(tp_src, 1)
        self.tp_dst = max(tp_dst, 1)
        self.fits = fits
        self.B = B
        # colocated: both "pools" are the same engine; the migration is
        # a slot splice, not a wire event (the single-engine baseline)
        self.colocated = colocated
        self.per_token_bytes, self.per_seq_bytes = \
            kv_cache_token_bytes(cfg)
        self.migrations = 0
        self.wire_bytes = 0.0
        self.comm_s = 0.0

    # --- pricing ---------------------------------------------------------

    def modeled_bytes(self, tokens: int) -> float:
        """Cache bytes of one request at ``tokens`` live rows."""
        return self.per_seq_bytes + tokens * self.per_token_bytes

    def latency_s(self, nbytes: float) -> float:
        """One p2p hop for the bundle (the pipeline's single-hop
        pricing)."""
        if self.colocated:
            return 0.0
        us = comm_time_us("collective_permute", nbytes / FLOAT_BYTES, 2,
                          self.fits)
        return us * 1e-6

    # --- sending ---------------------------------------------------------

    def send(self, bundle: KVBundle, now_s: float) -> KVBundle:
        """Price one migration and stamp its completion time.  The
        measured byte count prefers the bundle's actual rows (executed
        mode sets ``wire_bytes``); modeled bundles are billed at the page
        table's padded residency."""
        nbytes = bundle.wire_bytes or self.modeled_bytes(
            bundle.prefill_len)
        if self.colocated:
            nbytes = 0.0
        lat = self.latency_s(nbytes)
        bundle.wire_bytes = nbytes
        bundle.ready_s = now_s + lat
        self.migrations += 1
        self.wire_bytes += nbytes
        self.comm_s += lat
        if not self.colocated:
            rid = getattr(bundle.req, "req_id", -1)
            get_tracer().instant("fleet/transfer", cat="fleet",
                                 req=rid, bytes=nbytes,
                                 latency_us=lat * 1e6)
            get_metrics().counter(
                "fleet_transfer_bytes_total",
                "KV-cache bytes migrated prefill->decode").inc(nbytes)
            get_metrics().counter(
                "fleet_migrations_total",
                "requests migrated prefill->decode").inc()
        return bundle

    # --- the measured account --------------------------------------------

    def energy_j(self) -> float:
        """Transfer seconds billed at static power across both pools'
        endpoint devices (the compute account sees them idle while
        pages move)."""
        return self.comm_s * self.B * (self.tp_src + self.tp_dst)

    def measured(self) -> dict:
        return {
            "transfer_wire_bytes": self.wire_bytes,
            "migrations": self.migrations,
            "comm_us": self.comm_s * 1e6,
            "beta_s": self.comm_s,
            "energy_j": self.energy_j(),
            "bytes_per_migration": (self.wire_bytes / self.migrations
                                    if self.migrations else 0.0),
        }

    def predicted(self, migrations: int, mean_tokens: float,
                  fits: Optional[dict] = None) -> dict:
        """The a-priori transfer account for ``migrations`` requests at
        the trace's mean padded prompt length (the join partner for
        ``measured()`` in the ledger)."""
        return kv_transfer_prediction(
            self.cfg, migrations, mean_tokens, tp_src=self.tp_src,
            tp_dst=self.tp_dst, fits=fits or self.fits, B=self.B)
