"""Measurement scripts of hpx_tpu_torch, run on a CUDA card:
``python3 -m hpx_tpu_torch.tools.bench`` (the slice-1 metrics), and
``flash_ab.py`` / ``paged_ab.py`` (A/B timing of two checkouts)."""
