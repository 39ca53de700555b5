"""flashlint fixture: FL005 — an *aliased* deprecated-shim import, the
case a grep for the bare name cannot see through."""
from repro_torch.core.tfidf import DeviceTableAdapter as DTA


def open_table(cfg):
    return DTA(cfg)
