"""Model families, each as two files of its own: ``families/<family>.py``
and its plain reference ``reference/<family>.py``.

A configuration file names its family under ``"family"``.  The shared code
(``port.py``, ``weights.py``, ``yardstick.py``, ``faults.py``, ``check.py``
and ``harness.py``) names none: it loads both files by path, under the root
of the run's checkout, with ``load_file``, which loads the metric files too.
A family joins the benchmark as these two files, and no other file is
edited.
``harness.load_cell`` records the checkout in the configuration
(``at_root``) and refuses a cell whose family lacks either file.  Each
family is loaded once per checkout and family.

A family module gives:

``FIELDS``
    configuration-file key -> the program's ``ModelConfig`` field, beside
    those every family shares (``port.COMMON_FIELDS``).  A key the file
    leaves out keeps the value of the program's registered architecture.
``NESTED``
    a ``ModelConfig`` field that holds a sub-config -> {configuration-file
    key -> the sub-config's field}.  The file states every such key.
``specs(cfg)``
    the layer weights: name -> (shape, init, scale), each name starting with
    ``"layers."`` and its shape stacked over the layers on the first axis
    (``weights.stacked``).  ``init`` is ``"normal"`` (a standard normal
    times ``scale``, drawn in the served type) or a function that takes a
    float32 tensor uniform in [0, 1) and returns the weight.
``after_draw(cfg, w)``
    any change to the drawn tensors ``w``, in place, once all are drawn.
``param_name(cfg, key, i)``
    the program's parameter name for slice ``i`` of ``"layers.<key>"``.
``projection_params(cfg)``
    the weights that multiply every token (the projections), summed over
    the layers; the head is counted apart.
``mixer_flops(cfg, seq)``
    the sequence mixer's FLOPs in one prefill of one sequence of ``seq``
    tokens, summed over the layers.
``state_unchanged()``
    a context manager under which a decode step leaves its state as it was.

A reference module gives ``logits(weights, cfg, tokens, positions,
fp8=False)`` (``reference/__init__.py``).
"""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
# the key under which a configuration records the checkout it was read from
ROOT_KEY = "_root"


def at_root(cfg: dict, root) -> dict:
    """The configuration ``cfg`` read from the checkout at ``root``."""
    return {**cfg, ROOT_KEY: str(root)}


def files(cfg) -> list:
    """The family file and the reference file of the configuration ``cfg``,
    under the checkout it records (``at_root``)."""
    if ROOT_KEY not in cfg:
        raise ValueError(f"configuration {cfg.get('name')!r} records no checkout: "
                         "read it with harness.load_cell or families.at_root")
    root = Path(cfg[ROOT_KEY])
    return [root / BENCH_DIR.name / sub / f"{cfg['family']}.py"
            for sub in ("families", "reference")]


def module(cfg):
    """The family module of ``cfg``, loaded from its file."""
    return _loaded(files(cfg)[0], "family")


def reference(cfg):
    """The plain reference of ``cfg``'s family, loaded from its file."""
    return _loaded(files(cfg)[1], "reference")


@functools.lru_cache(maxsize=None)
def _loaded(path: Path, kind: str):
    return load_file(path, kind)


def load_file(path: Path, kind: str):
    """The module in the file at ``path``, loaded by path under the name
    ``<bench>_<kind>_<stem>``; a file that is not there raises
    FileNotFoundError."""
    spec = importlib.util.spec_from_file_location(f"{BENCH_DIR.name}_{kind}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
