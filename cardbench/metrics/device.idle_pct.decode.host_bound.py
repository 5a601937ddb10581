"""device.idle_pct.decode in the cells whose decode steps the host bounds:
the same reading, under the name of the end-to-end metric it moves there
(``tokens_per_s.host_bound``)."""
from pathlib import Path

from cardbench.harness import read_file

read = read_file(Path(__file__).with_name("device.idle_pct.decode.py"))
