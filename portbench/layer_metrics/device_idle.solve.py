"""The share of the traced slice in which no operation ran on the card,
in %: 1 - (union of device operations) / (slice length)."""

from portbench.stats import idle_pct


def read(rec: dict):
    return idle_pct(rec)
