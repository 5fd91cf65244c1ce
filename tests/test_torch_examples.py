"""The port's examples on the CPU, each in a one-thread subprocess
(``--device cpu``, the kernels' plain versions): ``quickstart_torch.py``
trains and serves, ``serve_confidential_torch.py`` seals, attests, opens
and serves continuous and wave, ``federated_healthcare_torch.py`` trains
four label-skewed hospitals with a budget on one. Its shards, per-silo
epsilons, the excluded hospital and the signed report's spend columns
equal those of JAX's ``federated_healthcare.py``, run beside it: they
depend only on the data split, participation and budgets. And the sealed
weights' codec (``components._ser`` / ``_deser``, JAX's wrappers over the
wire codec) round trips, packed and pickled."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.tee import components, wire
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TIMEOUT = 240


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env() -> dict:
    return {**os.environ, "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
            "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
            "PYTHONPATH": str(ROOT / "src")}


@pytest.fixture(scope="module")
def runs():
    """Every example started at once (the JAX twin of the healthcare
    example beside the port's); each test waits for its own."""
    procs = {name: subprocess.Popen(
        [sys.executable, str(EXAMPLES / script), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT)
        for name, script, extra in (
            ("quickstart", "quickstart_torch.py", ("--device", "cpu")),
            ("confidential", "serve_confidential_torch.py",
             ("--device", "cpu")),
            ("healthcare", "federated_healthcare_torch.py",
             ("--device", "cpu")),
            ("healthcare_jax", "federated_healthcare.py", ()))}
    done: dict = {}

    def result(name: str) -> str:
        if name not in done:
            out, err = procs[name].communicate(timeout=TIMEOUT)
            assert procs[name].returncode == 0, \
                f"{name}:\n{out}\n{err[-3000:]}"
            done[name] = out
        return done[name]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def test_quickstart_trains_and_serves(runs):
    out = runs("quickstart")
    m = re.search(r"final loss: ([\d.]+) \| clip bound: ([\d.]+)", out)
    assert m and np.isfinite(float(m.group(1))) and float(m.group(2)) > 0
    assert out.count("step ") == 4  # log_every 5 over 20 steps
    gen = re.search(r"generated: (\[\[.*\]\])", out)
    toks = np.array(eval(gen.group(1)))  # noqa: S307 - our own printout
    assert toks.shape == (2, 8) and (toks >= 0).all()


def test_serve_confidential_seals_attests_and_serves(runs):
    out = runs("confidential")
    assert "encrypted model uploaded to untrusted storage" in out
    assert "server attested; weights decrypted inside the trust domain, " \
           "on cpu" in out
    stats = {k: (float(u), int(n)) for k, u, n in re.findall(
        r"(continuous|wave)\s+utilization=([\d.]+) .*\((\d+) tokens\)", out)}
    assert set(stats) == {"continuous", "wave"}
    # the same requests, the same tokens served; continuous packs better
    assert stats["continuous"][1] == stats["wave"][1] > 0
    assert stats["continuous"][0] > stats["wave"][0]
    assert "generated (continuous): [[" in out


def _spend(out: str) -> dict:
    """The lines of the healthcare example that depend only on the split,
    participation and budgets."""
    table = re.findall(r"^\| (\d) \| (\d+) \| (\d+) \| ([\d.]+) \| (\S+) \| "
                       r"(\S+) \| (\S+) \|", out, re.M)
    return {
        "shards": re.findall(r"^hospital \d: .*$", out, re.M),
        "eps": [re.sub(r"loss=\S+ test_acc=\S+ ", "", ln) for ln in
                re.findall(r"^step .*per-silo eps.*$", out, re.M)],
        "per_silo": re.findall(r"^  hospital \d: eps=.*$", out, re.M),
        "excluded": re.findall(r"excluded hospital\(s\) \[[\d, ]*\]", out),
        "global": re.findall(r"^global .*$", out, re.M),
        "report": re.findall(r"^mode=.*$", out, re.M),
        "table": table,
        "exclusion": re.findall(r"^silo \d excluded at step .*$", out, re.M),
    }


def test_federated_healthcare_spend_equals_jax(runs):
    got, want = _spend(runs("healthcare")), _spend(runs("healthcare_jax"))
    assert got == want
    assert len(got["shards"]) == 4 and len(got["table"]) == 4
    assert got["excluded"] == ["excluded hospital(s) [3]"]
    assert got["table"][3][4:7] == ("60.0000", "0.0000", "EXHAUSTED")
    assert "signature: VERIFIED" in runs("healthcare")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _weights():
    cfg = get_smoke_config("qwen2.5-3b")
    return cfg, params_to_numpy(transformer.init(
        torch.Generator().manual_seed(0), cfg, "cpu"))


def _equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_sealed_weights_round_trip_into_a_model():
    """The example's route: the nested tree (the pickle + npz fallback),
    ``_deser(_ser(tree))`` bit for bit, and the weights back into a model
    unchanged."""
    cfg, tree = _weights()
    want = dict(_leaves(tree))
    blob = components._ser(tree)
    _equal(dict(_leaves(components._deser(blob))), want)
    model = params_from_jax(components._deser(blob), cfg, "cpu")
    _equal(dict(_leaves(params_to_numpy(model))), want)


@pytest.mark.parametrize("codec", ["packed", "pickle"])
def test_flat_weights_round_trip_in_both_codecs(codec):
    """A flat dict of fp32 leaves takes the packed codec (``_ser``'s);
    the pickle one, asked of ``wire.encode_tree``, differs; either comes
    back bit for bit."""
    _, tree = _weights()
    flat = dict(_leaves(tree))
    blob = wire.encode_tree(flat, codec=codec)
    assert (blob == components._ser(flat)) == (codec == "packed")
    _equal({k: np.asarray(v) for k, v in components._deser(blob).items()},
           flat)
