"""The wire tier's trust plane in the port (``repro_torch.core.tee``, the
ledger's budgets, membership) against the JAX package on the same inputs:
sealed blobs open across the two packages in both directions and both
keystream versions, Merkle roots and paths are equal, attestation
signatures are equal, the KDS refuses a wrong measurement or wire config,
the sandbox denies I/O, the ledger's verdicts, config and spend report are
equal after the same records, the synthetic MNIST arrays are bit-equal, and
MLP3's loss and gradients agree from carried weights (rtol 1e-5).

What only the card can show (the handlers' ``clip_mask`` launches, card
against CPU rounds) is checked by ``chip_smoke.py`` phase 16, not here.
"""
import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PrivacyConfig as JPrivacyConfig
from repro.core.privacy.ledger import PrivacyLedger as JLedger
from repro.core.tee import channels as jch
from repro.core.tee import merkle as jmerkle
from repro.core.tee.attestation import AttestationService as JAttestation
from repro.runtime.elastic import SiloMembership as JMembership
from repro_torch.configs.base import PrivacyConfig
from repro_torch.core.privacy import PrivacyLedger
from repro_torch.core.tee import channels, merkle, wire
from repro_torch.core.tee.attestation import (AttestationService,
                                              LaunchPolicy, measure_modules)
from repro_torch.core.tee.components import (Component, DataHandler,
                                             ManagementService)
from repro_torch.core.tee.kds import KeyDistributionService
from repro_torch.core.tee.sandbox import Sandbox, SandboxViolation
from repro_torch.runtime.elastic import SiloMembership
from repro_torch.runtime.straggler import SiloTelemetry

# MLP3's loss and gradients, fp32 products in other orders (XLA vs torch)
MODEL_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# channels: a blob sealed by either package opens in the other


@pytest.mark.parametrize("version", [channels.VER_FAST, channels.VER_LEGACY])
def test_sealed_blobs_open_across_packages(version):
    key = channels.derive_key(b"session-root", "dk-0")
    assert key == jch.derive_key(b"session-root", "dk-0")
    payload = np.arange(3000, dtype=np.float32).tobytes()
    from_port = channels.seal(key, payload, b"aad", version=version)
    from_jax = jch.seal(key, payload, b"aad", version=version)
    assert from_port[0] == from_jax[0] == version
    assert jch.open_sealed(key, from_port, b"aad") == payload
    assert channels.open_sealed(key, from_jax, b"aad") == payload
    # the keystreams themselves are the same functions of (key, nonce)
    np.testing.assert_array_equal(channels._keystream(key, b"n" * 16, 999),
                                  jch._keystream(key, b"n" * 16, 999))


@pytest.mark.parametrize("version", [channels.VER_FAST, channels.VER_LEGACY])
def test_tampered_truncated_or_replayed_blobs_rejected(version):
    key = channels.derive_key(b"m", "chan")
    blob = jch.seal(key, b"secret gradients", b"aad", version=version)
    tampered = blob[:-1] + bytes([blob[-1] ^ 1])
    with pytest.raises(channels.IntegrityError, match="authentication"):
        channels.open_sealed(key, tampered, b"aad")
    with pytest.raises(channels.IntegrityError, match="authentication"):
        channels.open_sealed(key, blob, b"other-aad")
    with pytest.raises(channels.IntegrityError, match="truncated"):
        channels.open_sealed(key, blob[:40], b"aad")
    # a JAX channel's messages into a port channel: replay refused, and a
    # failed open burns no counter
    a = jch.SecureChannel(key, "peer", version=version)
    b = channels.SecureChannel(key, "peer", version=version)
    m1, m2 = a.send(b"one"), a.send(b"two")
    with pytest.raises(channels.IntegrityError):
        b.recv(m1[:-1] + bytes([m1[-1] ^ 1]))
    assert b.recv(m1) == b"one" and b.recv(m2) == b"two"
    with pytest.raises(channels.IntegrityError, match="replay"):
        b.recv(m1)


def test_spend_report_mac_equals_jax():
    body = {"steps": 3, "silos": [{"silo": 0, "epsilon": 1.5}]}
    assert channels.spend_report_mac(body, "sig") == \
        jch.spend_report_mac(body, "sig")


# ---------------------------------------------------------------------------
# Merkle batch tags


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_merkle_roots_and_paths_equal_jax(n):
    leaves = [hashlib.sha256(bytes([i]) * 8).digest() for i in range(n)]
    ours, theirs = merkle.MerkleTree(leaves), jmerkle.MerkleTree(leaves)
    assert ours.root == theirs.root
    for i, leaf in enumerate(leaves):
        assert ours.path(i) == theirs.path(i)
        assert merkle.verify_path(ours.root, leaf, ours.path(i))
        assert not merkle.verify_path(ours.root, b"\x00" * 32, ours.path(i))
    with pytest.raises(IndexError, match="out of range"):
        ours.path(n)


# ---------------------------------------------------------------------------
# attestation, KDS, measurement


def test_attestation_signatures_equal_jax_and_verify():
    ours, theirs = AttestationService(), JAttestation()
    pol = LaunchPolicy()
    r = ours.issue("handler-0", "codehash", pol.hash(), "n1")
    assert r.signature == theirs.issue("handler-0", "codehash", pol.hash(),
                                       "n1").signature
    assert ours.verify(r)
    forged = type(r)(r.component, "evilhash", r.policy_hash, r.nonce,
                     r.signature)
    assert not ours.verify(forged)


def test_kds_refuses_wrong_measurement_policy_or_signature():
    svc = AttestationService()
    kds = KeyDistributionService(svc)
    pol = LaunchPolicy()
    kds.upload_key("dataset-0", b"k" * 32, "owner-a", "goodcode", pol.hash())
    assert kds.request_key("dataset-0", svc.issue("h", "goodcode", pol.hash(),
                                                  "n")) == b"k" * 32
    for report in (svc.issue("h", "badcode", pol.hash(), "n"),
                   svc.issue("h", "goodcode", "otherpolicy", "n"),
                   AttestationService(b"other-root").issue(
                       "h", "goodcode", pol.hash(), "n")):
        with pytest.raises(PermissionError, match="attestation failed"):
            kds.request_key("dataset-0", report)
    with pytest.raises(KeyError, match="unknown asset"):
        kds.request_key("nope", report)
    assert [e["code"] and e["policy"] and e["sig"]
            for e in kds.audit_log] == [True, False, False, False]


def test_kds_refuses_a_component_launched_under_another_wire_config():
    """The wire config (codec id, pinned layout) joins the measurement: a
    handler deployed with a tampered codec gets no key."""
    priv = PrivacyConfig(enabled=True, sigma=0.5)
    a, b = ManagementService(), ManagementService()
    a.create_session("s", 2, priv, wire_config={"codec": wire.WIRE_CODEC_ID,
                                                "layout": "aa" * 16})
    b.create_session("s", 2, priv, wire_config={"codec": wire.WIRE_CODEC_ID,
                                                "layout": "bb" * 16})
    assert a.expected_measurement() != b.expected_measurement()
    good = DataHandler("h-good", a, silo_idx=0)
    bad = DataHandler("h-bad", a, silo_idx=1)
    bad.launch_wire_config = {"codec": "pickle-npz-v0"}
    good.attest(a.policy)
    bad.attest(a.policy)
    a.kds.upload_key("dk", channels.derive_key(b"r", "dk"), "owner",
                     a.expected_measurement(), a.policy.hash())
    assert a.kds.request_key("dk", good.report)
    with pytest.raises(PermissionError, match="code=False"):
        a.kds.request_key("dk", bad.report)
    # one service measures one config: another session's terms are refused
    with pytest.raises(ValueError, match="different ledger/wire config"):
        a.create_session("t", 3, priv)


def test_measurement_covers_the_ports_own_modules():
    import repro_torch.core.barrier as b
    import repro_torch.core.masking as m
    assert measure_modules([b, m]) != measure_modules([m, b])
    assert measure_modules([b, m]) == measure_modules([b, m])
    svc = ManagementService()
    c = Component("c", svc)
    assert c.measurement() == svc.expected_measurement()


# ---------------------------------------------------------------------------
# the sandbox


def test_sandbox_denies_io_and_os_imports():
    sb = Sandbox()

    def writes(params, data):
        open("exfil.txt", "w").write("leak")  # noqa: SIM115
        return 0.0, params

    def imports_os(params, data):
        import os  # noqa: F401
        return 0.0, params

    def evals(params, data):
        return eval("1"), params

    for fn in (writes, imports_os, evals):
        with pytest.raises(SandboxViolation):
            sb.run(fn, {}, {})
    assert sb.violations == ["os"]


def test_sandbox_runs_torch_autograd_code():
    """The model owner's gradient code (torch.autograd.grad on fresh leaves,
    a torch import inside the function) runs under the restricted
    builtins."""
    from repro_torch.models.small import value_and_grad
    sb = Sandbox()

    def loss_fn(p, data):
        import torch as t
        return t.sum(p["w"] * data["x"]) ** 2

    loss, grads = sb.run(value_and_grad(loss_fn), {"w": torch.ones(3)},
                         {"x": torch.arange(3.0)})
    assert float(loss) == 9.0
    assert grads["w"].tolist() == [0.0, 6.0, 12.0]


# ---------------------------------------------------------------------------
# the ledger's budgets, membership, telemetry


def test_ledger_verdicts_config_and_report_equal_jax():
    cfg = dict(sigma=0.5, noise_lambda=0.3, delta=1e-5)
    budgets = {1: 6.0, 3: 12.0}
    ours = PrivacyLedger.from_privacy_config(
        PrivacyConfig(**cfg), 4, epsilon_budget=20.0, budgets=budgets)
    theirs = JLedger.from_privacy_config(
        JPrivacyConfig(**cfg), 4, epsilon_budget=20.0, budgets=budgets)
    assert ours.config_dict() == theirs.config_dict()
    assert ours.has_budgets() and theirs.has_budgets()
    masks = [None, [1, 1, 0, 1], [1, 1, 1, 0], None, [0, 1, 1, 1], None]
    for mask in masks:
        ours.record(None if mask is None else np.array(mask, bool))
        theirs.record(None if mask is None else np.array(mask, bool))
        np.testing.assert_array_equal(ours.allowed_mask(),
                                      theirs.allowed_mask())
        assert ours.take_exclusions() == theirs.take_exclusions()
        assert ours.exhausted() == theirs.exhausted()
    assert ours.exhausted(), "the budgets should run out in these records"
    rt = {0: 0.031, 2: 0.0405}
    assert ours.spend_report(round_trip_s=rt) == \
        theirs.spend_report(round_trip_s=rt)
    assert ours.contributions == theirs.contributions
    # a budget raise re-admits: the verdicts follow the table
    ours.budgets[1] = theirs.budgets[1] = 1e9
    np.testing.assert_array_equal(ours.allowed_mask(), theirs.allowed_mask())
    assert ours.take_exclusions() == theirs.take_exclusions()


def test_membership_matches_jax_event_for_event():
    """Drops with and without a cooldown, a refused drop (quorum), a budget
    exclusion refused a rejoin until the override: the same verdicts,
    participation sets and events as the JAX package's."""
    ours, theirs = SiloMembership(4, min_active=2), JMembership(4, min_active=2)
    ops = [("drop", 1, 1, 2), ("exclude", 3, 2), ("rejoin", 3, 3, False),
           ("drop", 0, 3, None), ("drop", 2, 3, None),
           ("rejoin", 3, 4, True), ("drop", 2, 5, None)]
    for op, silo, step, *arg in ops:
        got = [getattr(m, op)(silo, step, *arg) for m in (ours, theirs)]
        assert got[0] == got[1], (op, silo, step)
        for t in range(7):
            np.testing.assert_array_equal(ours.active_at(t),
                                          theirs.active_at(t))
    assert ours.events == theirs.events
    assert ours.excluded == theirs.excluded
    tel = SiloTelemetry(4)
    for silo, t in enumerate([0.1, 0.3, 0.2, 0.1]):
        tel.observe(silo, t)
    tel.observe(2, 0.9)  # EMA 0.7 * 0.2 + 0.3 * 0.9
    assert tel.slowest([0, 1, 2, 3]) == 2 and tel.slowest([]) is None
    assert tel.snapshot()[2] == pytest.approx(0.41)
    assert ours.drop_one(6, telemetry=tel) is None  # quorum holds
    assert SiloMembership(4).drop_one(0, telemetry=tel) == 2
    assert SiloMembership(4).drop_one(0) == 3  # no timing: highest index


# ---------------------------------------------------------------------------
# data and the model


def test_synthetic_mnist_bit_equal_jax():
    from repro.data.synthetic import synthetic_mnist as jmnist
    from repro_torch.data.synthetic import synthetic_mnist

    for a, b in zip(synthetic_mnist(n_train=256, n_test=64, seed=3),
                    jmnist(n_train=256, n_test=64, seed=3)):
        assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
    parts = synthetic_mnist(n_train=130, n_test=8)[0].split(4)
    assert [len(p) for p in parts] == [33, 33, 32, 32]


def test_mlp3_loss_and_grads_match_jax_from_carried_weights():
    from repro.configs.paper_models import MNIST_MLP3 as JMLP3
    from repro.models.small import build_small_model as jbuild
    from repro_torch.configs.paper_models import MNIST_MLP3
    from repro_torch.data.synthetic import synthetic_mnist
    from repro_torch.models.convert import small_params_from_jax
    from repro_torch.models.small import (MLP3, build_small_model,
                                          value_and_grad)

    jsm, sm = jbuild(JMLP3), build_small_model(MNIST_MLP3)
    jparams = jsm.init(jax.random.PRNGKey(1))
    params = small_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    assert set(params) == {f"l{i}.{k}" for i in range(3) for k in "wb"}
    data = synthetic_mnist(n_train=64, n_test=8)[0]
    jbatch = {"x": jnp.asarray(data.x), "y": jnp.asarray(data.y)}
    batch = {"x": torch.as_tensor(data.x), "y": torch.as_tensor(data.y)}
    jloss, jgrads = jax.value_and_grad(jsm.loss)(jparams, jbatch)
    loss, grads = value_and_grad(sm.loss)(params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=MODEL_RTOL)
    for path, g in grads.items():
        a, k = path.split(".")
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[a][k]),
                                   rtol=MODEL_RTOL, atol=MODEL_RTOL * 1e-2)
    np.testing.assert_allclose(float(sm.accuracy(params, batch)),
                               float(jsm.accuracy(jparams, jbatch)))
    # the module wrapper computes the functional model's logits
    mod = MLP3(MNIST_MLP3, torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(mod(batch["x"]),
                                   sm.apply(mod.params(), batch["x"]),
                                   rtol=0, atol=0)
    assert sum(p.numel() for p in mod.parameters()) == 235146


def test_small_cnn_and_wrn_raise_item_12():
    """The CIFAR models are ported: ``build_small_model`` builds both at
    their published configs with JAX's leaf paths and shapes and its
    parameter counts, 307,498 (CNN6, 14 leaves) and 5,849,050 (WRN28-4, 80
    leaves)."""
    from repro.configs.paper_models import CIFAR10_CNN6 as JCNN6
    from repro.configs.paper_models import CIFAR10_WRN28 as JWRN28
    from repro.models.small import build_small_model as jbuild
    from repro_torch.configs.paper_models import CIFAR10_CNN6, CIFAR10_WRN28
    from repro_torch.core import flatbuf
    from repro_torch.models.small import build_small_model

    for cfg, jcfg, n, leaves in ((CIFAR10_CNN6, JCNN6, 307_498, 14),
                                 (CIFAR10_WRN28, JWRN28, 5_849_050, 80)):
        tree = build_small_model(cfg).init(torch.Generator().manual_seed(0))
        jtree = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
        want = {".".join(str(k.key) for k in path): tuple(leaf.shape)
                for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)}
        assert {k: tuple(v.shape) for k, v in tree.items()} == want
        assert sum(v.numel() for v in tree.values()) == n
        assert flatbuf.layout_of(tree).n_leaves == leaves
        assert all(v.dtype == torch.float32 for v in tree.values())


def test_spend_report_signed_by_port_verifies_in_both_packages():
    """The admin's signed report: verified by the port and by the JAX
    package's verifier (the same MAC convention and root of trust), and
    refused once tampered."""
    from repro.analysis.report import verify_spend_report as jverify
    from repro_torch.analysis.report import (privacy_spend_table,
                                             verify_spend_report)
    from repro_torch.core.tee.components import Admin

    svc = ManagementService()
    svc.create_session("s", 2, PrivacyConfig(sigma=0.5))
    admin = Admin("admin", svc, ledger=PrivacyLedger.from_privacy_config(
        PrivacyConfig(sigma=0.5), 2, budgets={1: 0.001}), n_silos=2)
    admin.attest(svc.policy)
    admin.ledger.record(None)
    report = json.loads(json.dumps(admin.sign_spend_report({0: 0.02})))
    assert verify_spend_report(report, svc.attestation)
    assert jverify(report, JAttestation())
    assert verify_spend_report(report, svc.attestation,
                               expected_measurement=svc.expected_measurement())
    table = privacy_spend_table(report, attestation=svc.attestation)
    assert "signature: VERIFIED" in table and "EXHAUSTED" in table
    assert "| 20.000 |" in table and "| — |" in table
    forged = json.loads(json.dumps(report))
    forged["silos"][1]["exhausted"] = False
    assert not verify_spend_report(forged, svc.attestation)
    assert not verify_spend_report({"steps": 1}, svc.attestation)
