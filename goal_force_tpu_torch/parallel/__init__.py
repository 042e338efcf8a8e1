"""Placement of the pipeline's models across memories (host staging of the standby expert)."""
