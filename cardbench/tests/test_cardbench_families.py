"""Families as files of their own: the shared code names no family, and
what it makes of each configuration is what it made before the families
moved into ``families/`` (the values below were taken from that code)."""
import ast
import hashlib
import json
import re

import pytest
import torch

from cardbench import families, harness, port, weights, yardstick
from cardbench.tests.tiny import BENCH, REPO, make_root

SHARED = ["port.py", "weights.py", "yardstick.py", "faults.py", "check.py", "harness.py"]
# a family's name, or its file's
FAMILY_NAME = re.compile(r"(dense|ssm|moe|hybrid)(\.py)?")
SEED = 2**31 + 77

# SHA-256 of every drawn tensor (name, shape, type and bytes, by name) at SEED
WEIGHTS = {"tiny-dense": "b258cda80cd70b3c683efd94bb649a33fe8e03a730d21115e044948a19f0b416",
           "tiny-ssm": "55ed70d473c39fb4d0559117a5c3711649ca1549aa63a0f0daaad76b6a781234"}
# SHA-256 of the program's parameter names and shapes that the tensors map to
PORT_NAMES = {"tiny-dense": "da8acf4c08e8a2794217080b12d1464725ef7ab7a8324dbf32d58ce63463a843",
              "tiny-ssm": "d09cc7bde4ecaade494195e2f90d8bdc122cc3309788db963ee6404351f9ad3b"}
# SHA-256 of the weight specs (name, shape, scale) at full size
SPECS = {"internlm2-1.8b": "45e8396be421afcc49a870f3ffbf1c71c0d9e491ee97c89c8f7f16adc0e54f77",
         "mamba2-1.3b": "c779fa57a48df95194b83152b88705b2dd4f7c1311046821b82fe589f06ef61a"}
MODEL_CONFIG = {
    "internlm2-1.8b": (
        "ModelConfig(name='internlm2-1.8b', family='dense', num_layers=24, d_model=2048, "
        "num_heads=16, num_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=92544, "
        "qkv_bias=False, rope_theta=1000000.0, sliding_window=0, global_every=0, moe=None, "
        "ssm=None, hybrid=None, encoder=None, num_image_tokens=0, dtype='bfloat16', "
        "norm_eps=1e-05, tie_embeddings=False, attention_impl='flash', attention_chunk=1024, "
        "moe_impl='auto', moe_gather='auto', remat='dots', source='[arXiv:2403.17297; hf]')"),
    "mamba2-1.3b": (
        "ModelConfig(name='mamba2-1.3b', family='ssm', num_layers=48, d_model=2048, "
        "num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50288, qkv_bias=False, "
        "rope_theta=10000.0, sliding_window=0, global_every=0, moe=None, "
        "ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1, conv_width=4, "
        "chunk_size=256, dt_min=0.001, dt_max=0.1), hybrid=None, encoder=None, "
        "num_image_tokens=0, dtype='bfloat16', norm_eps=1e-05, tie_embeddings=True, "
        "attention_impl='auto', attention_chunk=1024, moe_impl='auto', moe_gather='auto', "
        "remat='dots', source='[arXiv:2405.21060; unverified]')"),
}
PREFILL_FLOPS = {("internlm2-1.8b", 4, 32768): 818051052208128.0,
                 ("internlm2-1.8b", 64, 1024): 204539865071616.0,
                 ("mamba2-1.3b", 4, 32768): 345135805890560.0,
                 ("mamba2-1.3b", 64, 1024): 172580673683456.0}


def config(name):
    return families.at_root(json.loads((BENCH / "configs" / f"{name}.json").read_text()), REPO)


def sha256_json(value):
    return hashlib.sha256(json.dumps(value).encode()).hexdigest()


@pytest.mark.parametrize("name", SHARED)
def test_the_shared_code_names_no_family(name):
    """No string literal of the shared code is a family's name or file, and
    none is compared with a configuration's family: each family's code is
    in its own file."""
    assert not family_branches(ast.parse((BENCH / name).read_text()))


@pytest.mark.parametrize("src", ['if cfg["family"] == "dense": pass',
                                 'x = cfg.get("family") in ("m" + "oe",)',
                                 'x = {"ssm": 1}', 'p = root / "hybrid.py"',
                                 'x = c.family != "other"'])
def test_the_family_scan_sees_a_branch(src):
    assert family_branches(ast.parse(src))


def family_branches(tree):
    """Lines of ``tree`` with a string literal that is a family's name or
    file, or that compare a configuration's family with a string literal."""
    named = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Constant)
             and isinstance(n.value, str) and FAMILY_NAME.fullmatch(n.value)]
    compared = [n.lineno for n in ast.walk(tree)
                if isinstance(n, ast.Compare) and _reads_family(n)
                and any(isinstance(c, ast.Constant) and isinstance(c.value, str)
                        and c.value != "family"
                        for side in [n.left, *n.comparators] for c in ast.walk(side))]
    return named + compared


def _reads_family(node):
    """Whether ``node`` looks up a family: ``x["family"]``,
    ``x.get("family")`` or ``x.family``."""
    for n in ast.walk(node):
        if isinstance(n, ast.Subscript) and getattr(n.slice, "value", None) == "family":
            return True
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "get" and any(
                getattr(a, "value", None) == "family" for a in n.args):
            return True
        if isinstance(n, ast.Attribute) and n.attr == "family":
            return True
    return False


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_the_same_seed_draws_the_same_weights(tmp_path, name):
    cfg = harness.load_cell(make_root(tmp_path), f"{name}.tinymix")[1]
    w = weights.draw(cfg, SEED, "cpu")
    h = hashlib.sha256()
    for k in sorted(w):
        t = w[k]
        h.update(f"{k} {tuple(t.shape)} {t.dtype};".encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == WEIGHTS[name]
    state = weights.port_state(cfg, w)
    assert sha256_json(sorted((k, list(v.shape)) for k, v in state.items())) == PORT_NAMES[name]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_the_weight_specs_at_full_size(name):
    rows = [[k, list(shape), scale]
            for k, (shape, init, scale) in sorted(weights.specs(config(name)).items())]
    assert sha256_json(rows) == SPECS[name]


@pytest.mark.parametrize("name", sorted(MODEL_CONFIG))
def test_the_program_gets_the_same_model_config(name):
    assert repr(port.model_config(config(name))) == MODEL_CONFIG[name]


@pytest.mark.parametrize("name,batch,seq", sorted(PREFILL_FLOPS))
def test_the_same_prefill_flops(name, batch, seq):
    assert yardstick.prefill_flops(config(name), batch, seq) == PREFILL_FLOPS[name, batch, seq]


def test_a_family_is_found_under_the_configurations_root(tmp_path):
    cfg = families.at_root(config("mamba2-1.3b"), tmp_path)
    assert families.files(cfg) == [tmp_path / BENCH.name / "families" / "ssm.py",
                                   tmp_path / BENCH.name / "reference" / "ssm.py"]
    with pytest.raises(FileNotFoundError):
        families.module(cfg)


def test_a_configuration_without_its_checkout_finds_no_family():
    cfg = config("mamba2-1.3b")
    del cfg[families.ROOT_KEY]
    with pytest.raises(ValueError, match="records no checkout"):
        families.module(cfg)


def test_a_family_is_loaded_once_per_checkout(tmp_path):
    root = make_root(tmp_path)
    cfg = harness.load_cell(root, "tiny-ssm.tinymix")[1]
    assert families.module(cfg) is families.module(dict(cfg))
    assert families.reference(cfg) is families.reference(cfg)
    assert families.module(cfg) is not families.module(config("mamba2-1.3b"))
