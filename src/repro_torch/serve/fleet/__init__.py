"""Disaggregated prefill/decode serving fleet (the reference's
``serve/fleet``): separately-configured pools, a priced KV-page transfer
channel, and joules-per-token-aware autoscaling over a virtual-clock
discrete-event replay, modeled or executed on real engines."""
from repro_torch.serve.fleet.autoscaler import (AutoscalePolicy, Autoscaler,
                                                PoolStats, ScaleEvent)
from repro_torch.serve.fleet.router import (ROUTE_SCHEMA, FleetConfig,
                                            FleetRouter, auto_rate_rps,
                                            baseline_config,
                                            load_route_table, plan_pools,
                                            write_route_table)
from repro_torch.serve.fleet.runners import (DecodePool, DecodeReplica,
                                             FleetRequest, PoolAccount,
                                             PrefillPool, form_group)
from repro_torch.serve.fleet.transfer import KVBundle, TransferChannel

__all__ = [
    "AutoscalePolicy", "Autoscaler", "PoolStats", "ScaleEvent",
    "ROUTE_SCHEMA", "FleetConfig", "FleetRouter", "auto_rate_rps",
    "baseline_config", "load_route_table", "plan_pools",
    "write_route_table",
    "DecodePool", "DecodeReplica", "FleetRequest", "PoolAccount",
    "PrefillPool", "form_group", "KVBundle", "TransferChannel",
]
