"""The card line that the port's tools print beside their numbers: the
card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them (a card set below its maximum power runs
slower under load, so a time means little without it)."""

import subprocess


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
