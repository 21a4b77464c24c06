"""Host-side data helpers (numpy only), copied from ``repurpose_tpu.data``."""
