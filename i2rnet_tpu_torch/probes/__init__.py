"""Short card checks run ahead of ``chip_smoke.py`` while a kernel is new."""
