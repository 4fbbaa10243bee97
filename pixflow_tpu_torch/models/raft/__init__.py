"""RAFT, small and basic: the port of `pixflow_tpu/models/raft/`. Its
correlation lookup reads through K2's grid-sample entry on the card, and
its gradient through that entry's backward kernel (`corr.py`)."""

from .convert import load_raft, raft_flax_to_torch
from .corr import build_corr_pyramid, lookup_corr
from .raft import RAFT, convex_upsample_flow, raft_batch_flows, seeded_raft

__all__ = ["RAFT", "build_corr_pyramid", "convex_upsample_flow", "load_raft",
           "lookup_corr", "raft_batch_flows", "raft_flax_to_torch", "seeded_raft"]
