"""Host-side data contract (only the depth constants are ported so far)."""
