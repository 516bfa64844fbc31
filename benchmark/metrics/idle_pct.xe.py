"""Share of the traced sub-window of an X-Engine cell in which no
operation ran on the card (%)."""

from benchmark.readers import idle_pct as read  # noqa: F401
