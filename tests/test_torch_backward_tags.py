"""``traffic_by_tag`` counts the backward of a tagged region
(``analysis.account``): the scopes open in the forward are stored on each
output's autograd node, and an op the backward dispatches takes its
node's scopes, as JAX's tags reach the transposed ops
(``src/repro/analysis/hlo.py:193-200``).

* A matmul in the "attention_core" scope, its backward run outside it: the
  tag holds the forward's and the backward's bytes (each op's operands and
  result), and the untagged ops none of them.
* A reduced internlm2-1.8b train cell (remat "none"): the attention's
  backward ops are tagged with its forward's.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.account import account  # noqa: E402
from repro_torch.core.scope import named_scope  # noqa: E402


def test_backward_of_a_scoped_product_is_tagged():
    a = torch.randn(8, 16, requires_grad=True)
    b = torch.randn(16, 4, requires_grad=True)

    def step():
        with named_scope("attention_core"):
            y = a @ b
        y.backward(torch.ones(8, 4))

    _, acct = account(step)
    f = 4
    forward = (8 * 16 + 16 * 4 + 8 * 4) * f
    # the backward: grad_a = g @ b.T and grad_b = a.T @ g, each reading two
    # operands and writing one (the transposes are views)
    backward = (8 * 4 + 4 * 16 + 8 * 16) * f + (16 * 8 + 8 * 4 + 16 * 4) * f
    assert acct.traffic_by_tag == {"attention_core": forward + backward}
    assert acct.flops == 3 * 2 * 8 * 16 * 4


def test_train_cell_tags_its_backward(monkeypatch):
    """The attention's two products and its softmax, tagged in the forward,
    and their backward ops tagged too: each product's backward is two
    products of the same sizes (twice its bytes), the softmax's backward
    reads the gradient and the output and writes one (1.5 times the
    forward's read and write)."""
    from collections import Counter

    from repro_torch.analysis import account as acct_mod
    from repro_torch.launch.cells import build_cell
    tagged = Counter()
    count = acct_mod.Account._count

    def counted(self, func, args, kwargs, out):
        before = self.result.traffic_by_tag.get("attention_core", 0.0)
        count(self, func, args, kwargs, out)
        node = torch._C._current_autograd_node()
        tagged[(func.__name__, node is not None)] += (
            self.result.traffic_by_tag.get("attention_core", 0.0) - before)

    monkeypatch.setattr(acct_mod.Account, "_count", counted)
    cell = build_cell("internlm2-1.8b", "train_4k", reduced=True, accum=1)
    account(cell.run)
    assert tagged[("bmm.default", True)] == 2 * tagged[("bmm.default", False)] > 0
    assert tagged[("_softmax_backward_data.default", True)] == \
        1.5 * tagged[("_softmax.default", False)] > 0
