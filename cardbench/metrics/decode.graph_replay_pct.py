"""Share (%) of the traced decode steps that the program ran as a CUDA graph
replay: the ``graph`` attribute (capture, replay or eager) of its ``decode``
spans (``repro_torch.core.scope``).  None where the program records no
``decode`` span, or notes no ``graph`` on them."""


def read(run):
    from repro_torch.core import scope
    spans = scope.spans() if hasattr(scope, "spans") else []
    steps = [s for s in spans if s.tag == "decode"]
    if not any("graph" in s.attrs for s in steps):
        return None
    return 100.0 * sum(s.attrs.get("graph") == "replay" for s in steps) / len(steps)
