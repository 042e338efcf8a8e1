"""Host-side utilities (fidelity metrics)."""
