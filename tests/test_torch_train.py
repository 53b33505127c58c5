"""The port's optimizer, steps, fairness record and train loop against the
JAX package's, on the CPU."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu import config as jconfig
from skin_image_analysis_tpu.data.loader import BatchIterator
from skin_image_analysis_tpu.ops.preprocess import (
    AugmentConfig as JAugmentConfig,
    make_preprocess_fn as jmake_preprocess_fn,
)
from skin_image_analysis_tpu.train import evaluate as jevaluate
from skin_image_analysis_tpu.train import state as jstate
from skin_image_analysis_tpu.train import step as jstep
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.ops.preprocess import AugmentConfig
from skin_image_analysis_tpu_torch.train import evaluate as tevaluate
from skin_image_analysis_tpu_torch.train import loop as tloop
from skin_image_analysis_tpu_torch.train import state as tstate
from skin_image_analysis_tpu_torch.train import step as tstep
from skin_image_analysis_tpu_torch.utils import jsonl

SHAPES = [(6, 5), (3,), (4, 2)]


@pytest.mark.parametrize("moment_dtype,nu_dtype", [
    (None, None), ("bfloat16", None), (None, "bfloat16"),
])
def test_adam_matches_optax(moment_dtype, nu_dtype):
    """5 updates on fixed gradients: params to 1e-6, bf16 moments within
    one bf16 ulp."""
    cfg = dict(learning_rate=3e-3, moment_dtype=moment_dtype,
               nu_dtype=nu_dtype)
    rng = np.random.default_rng(0)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(5)]
    tx = jstate.make_optimizer(jconfig.OptimConfig(**cfg))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = tstate.make_optimizer(tconfig.OptimConfig(**cfg), tp)
    import optax

    for g in grads:
        upd, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(x) for x in g])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    adam = opt_state if nu_dtype else opt_state[0]
    assert opt.count == int(adam.count) == 5
    for mine, theirs in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
        for a, b in zip(mine, theirs):
            b = np.asarray(b)
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            diff = np.abs(a.float().numpy() - b.astype(np.float32))
            if b.dtype == np.float32:
                assert diff.max() <= 1e-6
            else:
                _, e = np.frexp(b.astype(np.float32))
                assert (diff <= np.exp2(e - 8.0)).all()


@pytest.mark.parametrize("sched", [
    dict(),
    dict(lr_schedule="step", lr_step_size=3, lr_gamma=0.5),
    dict(lr_schedule="exponential", lr_step_size=4, lr_gamma=0.3),
    dict(lr_schedule="cosine", lr_decay_steps=7),
    dict(lr_schedule="cosine", lr_decay_steps=7, lr_warmup_steps=3),
    dict(lr_warmup_steps=4),
])
def test_make_lr_matches_optax(sched):
    cfg = dict(learning_rate=0.2, **sched)
    want = jstate.make_lr(jconfig.OptimConfig(**cfg))
    got = tstate.make_lr(tconfig.OptimConfig(**cfg))
    for count in range(12):
        w = float(want(count)) if callable(want) else want
        g = got(count) if callable(got) else got
        assert g == pytest.approx(w, rel=1e-6, abs=1e-9)


def test_make_lr_rejects_bad_sizes():
    with pytest.raises(ValueError, match="lr_step_size"):
        tstate.make_lr(tconfig.OptimConfig(lr_schedule="step"))
    with pytest.raises(ValueError, match="unknown"):
        tstate.make_lr(tconfig.OptimConfig(lr_schedule="bogus"))


@pytest.mark.parametrize("masked,weights", [
    (False, None), (True, None), (True, (0.3, 1.7)), (False, (2.0, 0.5)),
])
def test_masked_loss_and_counts_match_jax(masked, weights):
    rng = np.random.default_rng(1)
    lp = np.log(rng.dirichlet([1, 1], 6)).astype(np.float32)
    labels = np.array([0, 1, 1, 0, 1, 0], np.int32)
    valid = np.array([1, 1, 0, 1, 0, 1], bool)
    batch = {"pixels": jnp.asarray(lp), "label": jnp.asarray(labels)}
    if masked:
        batch["valid"] = jnp.asarray(valid)
    loss_j, (corr_j, count_j, _) = jstep._loss_and_metrics(
        lambda v, x, **kw: x, None, None, batch, None,
        None if weights is None else jnp.asarray(weights), None, None)
    loss_t, corr_t, count_t = tstep.masked_loss_and_metrics(
        torch.from_numpy(lp), torch.from_numpy(labels),
        torch.from_numpy(valid) if masked else None, weights)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-6)
    assert int(corr_t) == int(corr_j) and int(count_t) == int(count_j)


SMALL_MODEL = dict(conv_features=(32, 64), linear_features=(16,),
                   dropout=(0.0,), image_size=32, compute_dtype="float32")


def test_all_invalid_step_is_inert():
    state = tstate.create_train_state(
        tconfig.ModelConfig(**SMALL_MODEL), tconfig.OptimConfig(), 0, "cpu")
    before = [p.detach().clone() for p in state.model.parameters()]
    gen_before = state.generator.get_state()
    arena = torch.randint(0, 256, (5, 3, 32, 32), dtype=torch.uint8)
    pre = tloop.make_preprocess_fn(32, train=True, augment=AugmentConfig(),
                                   layout="planar")
    idx = np.array([[0, 1], [2, 3]], np.int32)
    valid = np.array([[False, False], [False, False]])
    m = tstep.multi_train_step(state, arena, idx, idx % 2, valid,
                               preprocess_fn=pre)
    assert m["loss"].tolist() == [0.0, 0.0] and m["count"].tolist() == [0, 0]
    assert state.step == 0 and state.optimizer.count == 0
    assert torch.equal(state.generator.get_state(), gen_before)
    for a, b in zip(before, state.model.parameters()):
        assert torch.equal(a, b)
    valid[1, 0] = True  # one live row: the step runs and counts one row
    m = tstep.multi_train_step(state, arena, idx, idx % 2, valid,
                               preprocess_fn=pre)
    assert m["count"].tolist() == [0, 1] and state.step == 1


GROUPS = ("skin_tone", "sex", "control")


def _record_types(rec):
    return {k: (_record_types(v) if isinstance(v, dict) else type(v))
            for k, v in rec.items()}


def _check_record(got, want, tol):
    """Integers exact, floats within ``tol(key)`` (NaN equals NaN)."""
    for k in want:
        if isinstance(want[k], dict):
            _check_record(got[k], want[k], tol)
        elif isinstance(want[k], int):
            assert got[k] == want[k], k
        else:
            assert got[k] == pytest.approx(want[k], rel=0, abs=tol(k),
                                           nan_ok=True), k


def test_fairness_record_matches_jax():
    """Integers exact, floats to 1e-12, on scattered row ids with a
    missing-attribute code and an empty group."""
    rng = np.random.default_rng(3)
    n = 40
    labels = rng.integers(0, 2, n)
    codes = {g: rng.integers(-1, 2, n) for g in GROUPS}
    codes["control"][:] = 0  # the 'rich' group is empty
    perm = rng.permutation(n)
    log_probs = np.log(rng.dirichlet([1, 1], n)).astype(np.float32)
    preds = log_probs.argmax(-1)
    batches = [{"pred": jnp.asarray(preds[perm[i:i + 8]]),
                "log_probs": jnp.asarray(log_probs[perm[i:i + 8]]),
                "row_id": jnp.asarray(perm[i:i + 8]),
                "valid": jnp.ones(8, bool)} for i in range(0, n, 8)]
    table = types.SimpleNamespace(labels=labels, group_codes=codes)
    want = jevaluate.evaluate_fairness(
        None, None, batches, table, eval_step=lambda p, f, b, s: b)
    got = tevaluate.fairness_record(
        preds[perm], perm, np.exp(log_probs[perm][:, 1]), labels, codes,
        device="cpu")
    assert _record_types(got) == _record_types(want)
    _check_record(got, want, lambda k: 1e-12)


def test_host_and_device_audits_match_jax():
    """The host audit over instance dicts equals the JAX package's exactly,
    and the device reduction over group codes equals the host audit; one
    group is empty and some attributes are missing."""
    from skin_image_analysis_tpu.metrics import fairness as jfair
    from skin_image_analysis_tpu_torch.metrics import device as tdevice
    from skin_image_analysis_tpu_torch.metrics import fairness as tfair

    rng = np.random.default_rng(4)
    n = 50
    preds, labels = rng.integers(0, 2, n), rng.integers(0, 2, n)
    codes = {g: rng.integers(-1, 2, n) for g in GROUPS}
    codes["sex"][:] = 0  # no 'female' rows
    names = {"skin_tone": ("light", "dark"), "sex": ("male", "female"),
             "control": ("poor", "rich")}
    cls = ("benign", "malignant")
    instances = {
        i: {"prediction": cls[preds[i]], "benign_malignant": cls[labels[i]],
            **{g: (names[g][codes[g][i]] if codes[g][i] >= 0 else "")
               for g in GROUPS}}
        for i in range(n)}
    want = jfair.analyse_predictions(instances)
    assert tfair.analyse_predictions(instances) == want
    got = tdevice.analyse_predictions_device(
        torch.from_numpy(preds), torch.from_numpy(labels),
        {g: torch.from_numpy(c) for g, c in codes.items()},
        torch.ones(n, dtype=torch.bool))
    assert got == want


def test_balanced_class_weights_match_jax():
    from skin_image_analysis_tpu.toneclassifier.class_weight import (
        balanced_class_weights,
    )

    labels = np.array([0] * 622 + [1] * 3063)
    np.testing.assert_array_equal(tloop.balanced_class_weights(labels),
                                  balanced_class_weights(labels))
    with pytest.raises(ValueError, match="empty class"):
        tloop.balanced_class_weights(np.zeros(4, int))


def test_fit_arena_needs_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arena = np.zeros((2, 3, 8, 8), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.fit_arena(tconfig.TrainConfig(), arena, np.zeros(2), arena,
                        np.zeros(2), {}, str(tmp_path))


@pytest.mark.parametrize("pallas", ["on", "off"])
def test_fit_arena_refuses_a_pallas_switch(pallas, tmp_path):
    """``data.pallas_preprocess`` "on" and "off" train, as in the JAX
    package (``tests/test_torch_preprocess_switch.py`` holds their
    values); a switch other than auto|on|off is refused with JAX's
    ValueError."""
    cfg = tconfig.TrainConfig(
        epochs=1, eval_every=0,
        data=tconfig.DataConfig(pallas_preprocess=pallas, image_size=8,
                                batch_size=2, steps_per_dispatch=1),
        model=tconfig.ModelConfig(conv_features=(4,), linear_features=(8,),
                                  dropout=(0.0,), image_size=8,
                                  compute_dtype="float32"))
    arena = np.zeros((2, 3, 8, 8), np.uint8)
    res = tloop.fit_arena(cfg, arena, np.zeros(2), arena, np.zeros(2), {},
                          str(tmp_path), device="cpu")
    assert res.state.step == 1
    bad = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, pallas_preprocess="maybe"))
    with pytest.raises(ValueError, match="pallas must be auto|on|off"):
        tloop.fit_arena(bad, arena, np.zeros(2), arena, np.zeros(2), {},
                        str(tmp_path), device="cpu")


def test_jsonl_round_trip(tmp_path):
    path = str(tmp_path / "r.json")
    jsonl.append_record(path, {"a": np.int64(3), "b": torch.tensor(0.5),
                               "c": {"d": np.float32(2.0)}})
    with open(path, "a") as f:
        f.write('{"truncated": ')
    assert list(jsonl.read_records(path)) == [
        {"a": 3, "b": 0.5, "c": {"d": 2.0}}]


def test_train_config_json_loads_in_both_packages():
    tcfg = tconfig.TrainConfig(
        epochs=3, data=tconfig.DataConfig(input_affine=((1.0,), (0.0,))),
        optim=tconfig.OptimConfig(class_weights=(0.5, 2.0)))
    jcfg = jconfig.train_config_from_dict(json.loads(tconfig.to_json(tcfg)))
    assert jconfig.to_json(jcfg) == tconfig.to_json(tcfg)
    back = tconfig.train_config_from_dict(json.loads(jconfig.to_json(jcfg)))
    assert back == tcfg
    assert [f.name for f in dataclasses.fields(jconfig.TrainConfig)] == [
        f.name for f in dataclasses.fields(tconfig.TrainConfig)]


class _Store:
    def __init__(self, labels, group_codes=None):
        self.table = types.SimpleNamespace(
            labels=labels, row_ids=np.arange(len(labels)),
            group_codes=group_codes)
        self.bad_rows = None

    def __len__(self):
        return len(self.table.labels)


def test_fit_arena_matches_jax_loop(tmp_path):
    """Two epochs of the whole slice through the kernel path (the port's
    CPU twin vs JAX's Pallas kernel in interpret mode), same bridged
    initial weights, same epoch order and padding: per-step losses to
    rtol 1e-4, equal counts, records with equal key sets and types, and
    equal eval results (counts, accuracy and DI exact, AUCs to 1e-6)."""
    _fit_arena_vs_jax_loop(tmp_path, SMALL_MODEL)


def test_fit_arena_s2d_matches_jax_loop(tmp_path):
    """The same with the s2d stem: both loops have the preprocess kernel
    store the space-to-depth layout for training, and hand eval plain
    NHWC, which the model transforms."""
    _fit_arena_vs_jax_loop(tmp_path, dict(SMALL_MODEL, stem="s2d"))


def _fit_arena_vs_jax_loop(tmp_path, model_kw):
    rng = np.random.default_rng(0)
    n_train, n_test, bs, k = 22, 10, 4, 2
    train_arena = rng.integers(0, 256, (n_train, 3, 32, 32), dtype=np.uint8)
    test_arena = rng.integers(0, 256, (n_test, 3, 32, 32), dtype=np.uint8)
    train_labels = rng.integers(0, 2, n_train)
    test_labels = rng.integers(0, 2, n_test)
    codes = {g: rng.integers(-1, 2, n_test) for g in GROUPS}
    cfg = tconfig.TrainConfig(
        epochs=2, seed=0,
        data=tconfig.DataConfig(image_size=32, canonical_size=32,
                                batch_size=bs, augment=True,
                                steps_per_dispatch=k),
        model=tconfig.ModelConfig(**model_kw),
        optim=tconfig.OptimConfig(learning_rate=1e-3))
    still = AugmentConfig(random_crop=False, horizontal_flip=False)
    got = tloop.fit_arena(cfg, train_arena, train_labels, test_arena,
                          test_labels, codes, str(tmp_path), device="cpu",
                          augment=still)

    # the JAX loop, from the same initial weights
    init = tstate.create_train_state(cfg.model, cfg.optim, cfg.seed, "cpu")
    params = jax.tree.map(jnp.asarray, bridge.state_dict_to_flax(
        init.model.state_dict(), 32))
    jcfg = jconfig.train_config_from_dict(json.loads(tconfig.to_json(cfg)))
    state, _ = jstate.create_train_state(jcfg.model, jcfg.optim,
                                         jax.random.key(0))
    state = state.replace(params=params)
    train_pre = jmake_preprocess_fn(
        32, train=True, augment=JAugmentConfig(*still), layout="planar",
        pallas="on", out_dtype="float32",
        space_to_depth=model_kw.get("stem") == "s2d")
    eval_pre = jmake_preprocess_fn(32, train=False, layout="planar")
    multi = jstep.make_multi_train_step(k, preprocess_fn=train_pre)
    multi_eval = jstep.make_multi_eval_step(k, preprocess_fn=eval_pre)
    train_it = BatchIterator(_Store(train_labels), bs, shuffle=True,
                             drop_remainder=True, seed=cfg.data.seed + 1,
                             prefetch=0)
    test_store = _Store(test_labels, codes)
    test_it = BatchIterator(test_store, bs, shuffle=False, prefetch=0)
    jarena, jtest = jnp.asarray(train_arena), jnp.asarray(test_arena)
    for epoch in range(2):
        ms = []
        for ib, lb, vd in train_it.super_batches(k):
            state, m = multi(state, jarena, jnp.asarray(ib), jnp.asarray(lb),
                             jnp.asarray(vd))
            ms.append(jax.device_get(m))
        losses = np.concatenate([m["loss"] for m in ms])
        counts = np.concatenate([m["count"] for m in ms])
        np.testing.assert_array_equal(got.step_counts[epoch], counts)
        np.testing.assert_allclose(got.step_losses[epoch], losses,
                                   rtol=1e-4, atol=0)
        record = jevaluate.evaluate_fairness(
            state.params, state.apply_fn, test_it, test_store.table,
            multi_eval=multi_eval, arena=jtest, eval_k=k)
        live = counts > 0
        record.update(avg_batch_loss=float(losses[live].mean()),
                      train_accuracy=0.0, epoch=epoch, epoch_time_s=0.0,
                      eval_time_s=0.0)
        mine = got.records[epoch]
        assert _record_types(mine) == _record_types(record)
        assert set(mine) == set(tloop.RECORD_KEYS)
        assert mine["total"] == record["total"] == n_test
        audit = {k: v for k, v in record.items() if k not in (
            "avg_batch_loss", "train_accuracy", "epoch_time_s",
            "eval_time_s")}
        _check_record(mine, audit,
                      lambda k: 1e-6 if k.startswith("auc") else 0.0)
        assert mine["avg_batch_loss"] == pytest.approx(
            record["avg_batch_loss"], rel=1e-4)
    assert counts.tolist() == [bs] * 5 + [0]  # 22 rows: 5 steps + 1 inert
    assert list(jsonl.read_records(got.results_path)) == json.loads(
        json.dumps(got.records))


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "skin_image_analysis_tpu",
            "pandas", "PIL", "msgpack")


def test_port_runs_without_jax_or_the_jax_package(tmp_path):
    """The whole slice imports and trains, and the modules of the second
    slice (the fused phase-conv0, the pools, the FLOP count, the rig) and
    a Keras-compatible family (mobilenet_v2, a train-mode step and the
    bridge) run, with JAX, the JAX package, pandas, PIL and msgpack made
    unimportable."""
    import subprocess
    import sys
    import textwrap

    # torch's compiler stack, which checkpoint and FlopCounterMode load,
    # probes for optional packages with find_spec when it is imported,
    # where an absent package gives None and the blocker would raise:
    # import it first
    code = textwrap.dedent(f"""
        import sys
        import torch._dynamo
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {_BLOCKED!r}:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import numpy as np
        from skin_image_analysis_tpu_torch import config as C
        from skin_image_analysis_tpu_torch.train.loop import fit_arena
        import skin_image_analysis_tpu_torch.bridge
        rng = np.random.default_rng(0)
        arena = rng.integers(0, 256, (6, 3, 20, 20), dtype=np.uint8)
        cfg = C.TrainConfig(epochs=1, data=C.DataConfig(
            image_size=16, canonical_size=20, batch_size=2, augment=True,
            steps_per_dispatch=2), model=C.ModelConfig(
            image_size=16, conv_features=(32,), linear_features=(8,),
            dropout=(0.5,)))
        r = fit_arena(cfg, arena, rng.integers(0, 2, 6), arena,
                      rng.integers(0, 2, 6),
                      {{g: rng.integers(-1, 2, 6)
                        for g in ("skin_tone", "sex", "control")}},
                      {str(tmp_path)!r}, device="cpu")
        assert r.records[0]["total"] == 6
        import torch
        from skin_image_analysis_tpu_torch.ops.kernels.convblock_kernel \
            import fused_phase_conv0
        from skin_image_analysis_tpu_torch.ops import pooling
        from skin_image_analysis_tpu_torch.tools import perf_attrib
        w = torch.randn(32, 3, 7, 7, requires_grad=True)
        y = fused_phase_conv0(torch.randn(1, 3, 8, 8), w, torch.zeros(32))
        y.float().sum().backward()
        assert w.grad is not None
        pooling.max_pool_2x2_hybrid(torch.randn(1, 2, 4, 4))
        from skin_image_analysis_tpu_torch.models.cnn import build_model
        model = build_model(C.ModelConfig(
            image_size=16, conv_features=(32,), linear_features=(8,),
            dropout=(0.5,), stem="s2d", remat=True), device="cpu")
        model(torch.rand(2, 16, 16, 3)).sum().backward()
        model = build_model(C.ModelConfig(name="mobilenet_v2",
                                          image_size=32), device="cpu")
        model(torch.rand(2, 32, 32, 3), train=True,
              generator=torch.Generator().manual_seed(0)).sum().backward()
        sd = skin_image_analysis_tpu_torch.bridge.variables_to_state_dict(
            *skin_image_analysis_tpu_torch.bridge.state_dict_to_variables(
                model.state_dict(), 32), 32)
        assert sd.keys() == model.state_dict().keys()
        from skin_image_analysis_tpu_torch.utils.flops import (
            forward_flops_per_img)
        assert forward_flops_per_img(C.ModelConfig(
            image_size=16, conv_features=(32,), linear_features=(8,),
            dropout=(0.5,), stem="s2d")) > 0
        perf_attrib.run(["pconv0", "pools2", "--device", "cpu",
                         "--batch-size", "1", "--image-size", "16",
                         "--iters", "1"])
        assert not [m for m in sys.modules
                    if m.split(".")[0] in {_BLOCKED!r}]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_transfer_trainer_runs_without_jax_or_the_jax_package(tmp_path):
    """``train_classifier`` trains resnet18 (BatchNorm, five-crop eval,
    keep-best), saves and reloads its ``session_model.msgpack`` on a DICOM
    ``LesionTable``, then xception_small on the ITA input (five-crop
    eval); the ITA pipeline and the modal-ITA classifiers run, the Keras
    reader names h5py, and the tone classifier's modules and the
    ``images_to_ita`` CLI import, with jax, flax, optax, the JAX package,
    pandas, PIL, cv2, msgpack and h5py made unimportable."""
    import subprocess
    import sys
    import textwrap

    from tests.test_torch_data import write_dicom_cohort

    root = str(tmp_path / "cohort")
    write_dicom_cohort(root, 24, 40, seed=2)
    blocked = (*_BLOCKED, "cv2", "h5py")
    # one intra-op thread: the suite's workers share the CPU, and with
    # torch's default pool per process these small models' ops slow down
    # by 25x under that load (measured on 8 cores)
    code = textwrap.dedent(f"""
        import sys
        import torch._dynamo
        torch.set_num_threads(1)
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {blocked!r}:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import os
        from skin_image_analysis_tpu_torch.data.dataset import LesionTable
        from skin_image_analysis_tpu_torch.data.ingest import read_csv
        from skin_image_analysis_tpu_torch.train import checkpoint as ckpt
        from skin_image_analysis_tpu_torch.train.classify import (
            ClassifyConfig, train_classifier)
        import skin_image_analysis_tpu_torch.toneclassifier.trainer
        import skin_image_analysis_tpu_torch.cli.ham_train
        import skin_image_analysis_tpu_torch.cli.tone_classifier_train
        df = read_csv(os.path.join({root!r}, "metadata.csv"))
        df = df.where("benign_malignant",
                      lambda v: v in ("benign", "malignant"))
        tables = [LesionTable(df.take(range(12)), {root!r}),
                  LesionTable(df.take(range(12, len(df))), {root!r})]
        out = train_classifier(*tables, ClassifyConfig(
            model_name="resnet18", image_size=32, canonical_size=40,
            batch_size=4, epochs=1, steps_per_dispatch=2,
            five_crop_eval=True, checkpoint_best=True,
            out_dir={str(tmp_path / "out")!r}), verbose=False,
            device="cpu")
        cfg, sd = ckpt.load_model(out["model_path"])
        assert cfg.name == "resnet18" and "stem_bn.running_var" in sd
        assert sorted(os.listdir(out["out_dir"])) == [
            "metrics.jsonl", "session_model.msgpack",
            "session_model_best.msgpack", "session_test.csv",
            "session_train.csv", "train_config.json"]
        out = train_classifier(*tables, ClassifyConfig(
            model_name="xception_small", image_size=32, canonical_size=40,
            batch_size=4, epochs=1, steps_per_dispatch=2, input_mode="ita",
            five_crop_eval=True, out_dir={str(tmp_path / "ita")!r}),
            verbose=False, device="cpu")
        cfg, sd = ckpt.load_model(out["model_path"])
        assert cfg.name == "xception_small" and cfg.in_channels == 2
        assert sd["block1_conv1.weight"].shape[1] == 2
        import numpy as np
        import torch
        from skin_image_analysis_tpu_torch.data.ita import ita_pipeline
        from skin_image_analysis_tpu_torch.models import keras_io
        from skin_image_analysis_tpu_torch.toneclassifier import (
            ModalItaClassifier)
        import skin_image_analysis_tpu_torch.cli.images_to_ita
        px = torch.from_numpy(np.random.default_rng(0).integers(
            60, 230, (4, 16, 16, 3), dtype=np.uint8))
        modal = ita_pipeline(px)["modal_ita"].numpy()
        ModalItaClassifier("svm").fit(modal, np.array([0, 1, 0, 1]))
        try:
            keras_io.read_legacy_h5("weights.h5")
            raise AssertionError("read without h5py")
        except ImportError as e:
            assert "h5py" in str(e)
        assert not [m for m in sys.modules
                    if m.split(".")[0] in {blocked!r}]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
