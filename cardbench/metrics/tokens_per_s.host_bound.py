"""tokens_per_s in the cells whose decode steps the host bounds (the card
idles through most of a step), where the host's speed spreads it between
processes by 5-9%: the same reading under a name of its own, so that its
wider bound does not hide a loss in the cells that the card bounds."""
from pathlib import Path

from cardbench.harness import read_file

read = read_file(Path(__file__).with_name("tokens_per_s.py"))
