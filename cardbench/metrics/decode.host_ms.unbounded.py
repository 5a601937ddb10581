"""``decode.host_ms``'s reading, in the cells whose throughput has no end-to-
end bound: there the host's speed spreads it between runs by more than the
largest bound takes. A name of its own, so that it may name a metric that
such a cell reports as the one it moves; decode moves none of them."""
from pathlib import Path

from cardbench.families import load_file

read = load_file(Path(__file__).with_name("decode.host_ms.py"), "metric").read
