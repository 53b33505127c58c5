"""The port's online serving (``serve/server.py``) against the JAX
package's, on the CPU: the bucket ladder, ``InferenceSession.predict`` on
flagship, resnet18 (batch statistics, ImageNet normalization), input-affine
and ITA folders the JAX package wrote, ``decode_image_bytes``, the
batcher, every HTTP route and guard beside the JAX server's answers, hot
reload and its refusals, the watcher, the serve CLI, and a subprocess that
serves and exports with jax, flax, optax and the JAX package unimportable.
"""

import contextlib
import http.client
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from skin_image_analysis_tpu import config as jconfig
# imported here, not first inside a jit trace: the module makes a jnp
# constant at import, which a trace would capture as a tracer
from skin_image_analysis_tpu.data import ita as _jita  # noqa: F401
from skin_image_analysis_tpu.data import loader as jloader
from skin_image_analysis_tpu.serve import server as jserver
from skin_image_analysis_tpu.train import checkpoint as jckpt
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.cli import tone_bias_serve
from skin_image_analysis_tpu_torch.data import loader as tloader
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.serve import server as tserver
from skin_image_analysis_tpu_torch.serve.server import (
    DynamicBatcher,
    InferenceSession,
    make_http_server,
    start_reload_watcher,
)
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from tests.test_torch_pooling import one_torch_thread  # noqa: F401

MAX_BATCH = 8
SIZE = 16
FLAGSHIP = dict(conv_features=(4, 8), linear_features=(8,), dropout=(0.0,),
                image_size=SIZE, compute_dtype="float32")
AFFINE = [[255.0 / 128.0] * 3, [-1.0] * 3]
# kind -> (ModelConfig fields, train_config.json or None)
KINDS = {
    "flagship": (FLAGSHIP, None),
    "resnet18": (dict(name="resnet18", image_size=32,
                      compute_dtype="float32"),
                 {"data": {"normalize_imagenet": True},
                  "class_names": ["light", "dark"]}),
    "affine": (FLAGSHIP, {"data": {"input_affine": AFFINE}}),
    "ita": (dict(FLAGSHIP, conv_features=(4,), in_channels=2),
            {"data": {"normalize_imagenet": False},
             "class_names": ["light", "dark"]}),
}
_BLOCKED = ("jax", "jaxlib", "flax", "optax", "skin_image_analysis_tpu")


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_folder(folder, model: dict, seed: int = 0,
               train_config: dict | None = None) -> str:
    """An experiment folder the JAX package's ``save_model`` wrote: the
    port's seeded init of the model (so no JAX init is compiled) in Flax's
    layout, with random BatchNorm statistics where the model has them, and
    ``train_config`` as its ``train_config.json``."""
    folder = str(folder)
    os.makedirs(folder, exist_ok=True)
    cfg = jconfig.ModelConfig(**model)
    state_dict = build_model(
        tconfig.ModelConfig(**model), device="cpu",
        generator=torch.Generator().manual_seed(seed)).state_dict()
    rng = np.random.default_rng(seed)
    for name, v in state_dict.items():
        if name.endswith("running_var"):
            state_dict[name] = torch.from_numpy(
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif name.endswith("running_mean"):
            state_dict[name] = torch.from_numpy(
                rng.normal(0.0, 0.1, v.shape).astype(np.float32))
    params, stats = bridge.state_dict_to_variables(state_dict,
                                                   cfg.image_size)
    jckpt.save_model(os.path.join(folder, jckpt.MODEL_FILENAME), cfg,
                     params, stats)
    if train_config is not None:
        with open(os.path.join(folder, "train_config.json"), "w") as f:
            json.dump(train_config, f)
    return folder


def kind_folder(tmp, kind: str, seed: int = 0) -> str:
    model, train_config = KINDS[kind]
    return jax_folder(os.path.join(str(tmp), kind), model, seed,
                      train_config)


def pixels(n: int, size: int = SIZE, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), np.uint8)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_folders")
    return {kind: kind_folder(tmp, kind) for kind in KINDS}


@pytest.fixture(scope="module")
def sessions(folders):
    """kind -> (the JAX session, the port's session) of one folder."""
    return {kind: (jserver.InferenceSession.from_experiment(
                       folder, max_batch=MAX_BATCH),
                   InferenceSession.from_experiment(
                       folder, max_batch=MAX_BATCH, device="cpu"))
            for kind, folder in folders.items()}


@pytest.fixture(scope="module")
def session(sessions):
    return sessions["flagship"][1]


def assert_same_answers(got: dict, want: dict, atol: float = 1e-5) -> None:
    np.testing.assert_allclose(got["log_probs"], want["log_probs"],
                               atol=atol, rtol=0)
    np.testing.assert_array_equal(got["pred"], want["pred"])
    np.testing.assert_allclose(got["p_malignant"], want["p_malignant"],
                               atol=atol, rtol=0)


def test_bucket_ladder_matches_jax():
    for cap in (1, 2, 6, 8, 60, 64):
        assert tserver._buckets(cap) == jserver._buckets(cap)
    assert tserver._buckets(6) == [1, 2, 4, 6]


@pytest.mark.parametrize("n", [1, 3, 11])
@pytest.mark.parametrize("kind", list(KINDS))
def test_predict_matches_jax(sessions, kind, n):
    """n = 1, a batch padded to its bucket, and one above max_batch (split
    into chunks), on the same folder and pixels as the JAX session."""
    jsess, sess = sessions[kind]
    assert sess.image_size == jsess.image_size
    assert sess.class_names == jsess.class_names
    assert sess.buckets == jsess.buckets
    px = pixels(n, sess.image_size, seed=n)
    got, want = sess.predict(px), jsess.predict(px)
    assert got["log_probs"].shape == (n, 2) and got["pred"].shape == (n,)
    assert_same_answers(got, want)
    assert sess.compiled <= set(sess.buckets)


def test_session_pads_slices_and_refuses_empty(session):
    px = pixels(3, seed=20)
    out = session.predict(px)
    full = session.predict(np.concatenate([px, px[:1]]))
    np.testing.assert_array_equal(out["log_probs"], full["log_probs"][:3])
    one = session.predict(px[0])  # a 3-D image is a batch of one
    assert one["pred"].shape == (1,)
    with pytest.raises(ValueError, match="empty"):
        session.predict(np.zeros((0, SIZE, SIZE, 3), np.uint8))
    with pytest.raises(ValueError, match="max_batch"):
        InferenceSession(session._program, SIZE, max_batch=0, device="cpu")


def test_folder_the_port_wrote_serves_in_both(tmp_path):
    """A folder the port's ``save_model`` wrote (flagship and resnet18
    with random BatchNorm statistics) answers alike in both packages."""
    for name, model in (("flagship", FLAGSHIP),
                        ("resnet18", KINDS["resnet18"][0])):
        cfg = tconfig.ModelConfig(**model)
        net = build_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
        state = net.state_dict()
        gen = torch.Generator().manual_seed(4)
        for k, v in state.items():
            if "running_mean" in k:
                v.copy_(torch.randn(v.shape, generator=gen) * 0.1)
            elif "running_var" in k:
                v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
        folder = str(tmp_path / name)
        os.makedirs(folder)
        tckpt.save_model(os.path.join(folder, tckpt.MODEL_FILENAME), cfg,
                         state)
        px = pixels(3, cfg.image_size, seed=5)
        assert_same_answers(
            InferenceSession.from_experiment(folder, max_batch=4,
                                             device="cpu").predict(px),
            jserver.InferenceSession.from_experiment(
                folder, max_batch=4).predict(px))


def _png(img: np.ndarray) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".png", img[:, :, ::-1])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("side", [16, 40, 9])
def test_decode_image_bytes_matches_jax(side):
    """The same size, a shrink (INTER_AREA) and a blow-up (INTER_LINEAR)."""
    img = pixels(1, side, seed=side)[0]
    data = _png(img)
    got = tloader.decode_image_bytes(data, SIZE)
    np.testing.assert_array_equal(got, jloader.decode_image_bytes(data,
                                                                  SIZE))
    assert got.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
    if side == SIZE:
        np.testing.assert_array_equal(got, img)  # PNG is lossless
    with pytest.raises(IOError):
        tloader.decode_image_bytes(b"not an image", SIZE)


def test_decode_image_bytes_pil_and_no_decoder(monkeypatch):
    """Without cv2 it decodes through PIL as the JAX package does; without
    either it raises an ImportError naming both."""
    img = pixels(1, 40, seed=6)[0]
    data = _png(img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(tloader.decode_image_bytes(data, SIZE),
                                  jloader.decode_image_bytes(data, SIZE))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="cv2.*PIL"):
        tloader.decode_image_bytes(data, SIZE)


def test_batcher_coalesces_queued_requests(session):
    batcher = DynamicBatcher(session, window_ms=1.0)
    images = pixels(5, seed=2)
    futures = [batcher.submit(img) for img in images]
    assert batcher.drain_once(wait=False) == 5
    assert batcher.stats.snapshot() == {"requests": 5, "batches": 1,
                                        "rows": 5, "max_coalesced": 5}
    ref = session.predict(images)
    for i, fut in enumerate(futures):
        res = fut.result(timeout=5)
        assert set(res) == {"log_probs", "pred", "p_malignant"}
        assert int(res["pred"]) == int(ref["pred"][i])
        np.testing.assert_array_equal(res["log_probs"], ref["log_probs"][i])


def test_batcher_worker_errors_and_stop(session):
    batcher = DynamicBatcher(session, window_ms=1.0).start()
    img = pixels(1, seed=3)[0]
    try:
        assert int(batcher.submit(img).result(timeout=30)["pred"]) in (0, 1)
        for bad in ((2, SIZE, SIZE, 3), (SIZE + 2, SIZE + 2, 3),
                    (SIZE, SIZE, 2)):
            with pytest.raises(ValueError, match="got"):
                batcher.submit(np.zeros(bad, np.uint8))
        assert int(batcher.submit(img).result(timeout=30)["pred"]) in (0, 1)
    finally:
        batcher.stop()
    assert not batcher._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        batcher.submit(img)


def test_batcher_delivers_exceptions_not_crashes(folders):
    sess = InferenceSession.from_experiment(folders["flagship"],
                                            max_batch=4, device="cpu")
    boom = {"on": True}
    real = sess.predict

    def flaky(px):
        if boom["on"]:
            raise RuntimeError("injected")
        return real(px)

    sess.predict = flaky
    batcher = DynamicBatcher(sess, window_ms=1.0)
    fut = batcher.submit(np.zeros((SIZE, SIZE, 3), np.uint8))
    batcher.drain_once(wait=False)
    with pytest.raises(RuntimeError, match="injected"):
        fut.result(timeout=5)
    boom["on"] = False
    fut2 = batcher.submit(np.zeros((SIZE, SIZE, 3), np.uint8))
    batcher.drain_once(wait=False)
    assert int(fut2.result(timeout=5)["pred"]) in (0, 1)


@contextlib.contextmanager
def serving(sess, module=tserver, **kw):
    """A server of ``module`` (the port's or the JAX package's) on
    ``sess`` at a free port; yields its base URL."""
    batcher = module.DynamicBatcher(sess, window_ms=kw.pop("window_ms",
                                                           1.0)).start()
    server = module.make_http_server(batcher, host="127.0.0.1", port=0,
                                     **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()


def request(url: str, data: bytes | None = None,
            ctype: str = "application/octet-stream") -> tuple[int, dict]:
    """(status, JSON body) of a GET (no data) or POST."""
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": ctype},
        method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def both_servers(sessions, folders):
    """The JAX server and the port's on the flagship folder."""
    jsess, sess = sessions["flagship"]
    with serving(jsess, jserver) as jbase, serving(sess) as base:
        yield jbase, base


_OTHER = json.dumps({"folder": "/nonexistent/other"}).encode()
ROUTES = {
    "healthz": ("/healthz", None, ""),
    "stats": ("/stats", None, ""),
    "get_404": ("/nope", None, ""),
    "raw": ("/predict", pixels(1, seed=4)[0].tobytes(),
            "application/octet-stream"),
    "png": ("/predict", "png", "image/png"),
    "raw_wrong_length": ("/predict", b"abc", "application/octet-stream"),
    "empty": ("/predict", b"", "application/octet-stream"),
    "bad_image": ("/predict", b"garbage", "image/jpeg"),
    "batch": ("/predict_batch", pixels(5, seed=11).tobytes(),
              "application/octet-stream"),
    "batch_misaligned": ("/predict_batch", b"xy",
                         "application/octet-stream"),
    "post_404": ("/nope", b"x", "application/octet-stream"),
    "reload_bad_json": ("/reload", b"{nope", "application/json"),
    "reload_other_403": ("/reload", _OTHER, "application/json"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_http_route_matches_jax(both_servers, route):
    """Each route answers with the JAX server's status and JSON keys, and
    a prediction with its numbers."""
    path, data, ctype = ROUTES[route]
    if data == "png":
        data = _png(pixels(1, seed=4)[0])
    jbase, base = both_servers
    (jcode, jbody), (code, body) = (request(b + path, data, ctype)
                                    for b in (jbase, base))
    assert code == jcode
    assert set(body) == set(jbody)
    if route == "healthz":
        for k in ("status", "source", "image_size", "class_names",
                  "buckets", "reloads"):
            assert body[k] == jbody[k], k
    elif route == "stats":
        assert body["rss_kb"] > 0
    elif code == 200:
        assert body["pred"] == jbody["pred"]
        assert body["class"] == jbody["class"]
        np.testing.assert_allclose(body["p_malignant"], jbody["p_malignant"],
                                   atol=1e-5)
        if "log_probs" in body:
            np.testing.assert_allclose(body["log_probs"], jbody["log_probs"],
                                       atol=1e-5)


def test_http_predict_png_equals_raw(both_servers):
    _, base = both_servers
    img = pixels(1, seed=7)[0]
    _, raw = request(base + "/predict", img.tobytes())
    _, png = request(base + "/predict", _png(img), "image/png")
    assert raw == png


def test_http_keepalive_across_requests_and_errors(both_servers):
    """HTTP/1.1: one connection serves a success, a 400 whose body was
    read, and a success again."""
    _, base = both_servers
    host, port = base.removeprefix("http://").split(":")
    img = pixels(1, seed=12)[0]
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/predict", img.tobytes(),
                     {"Content-Type": "application/octet-stream"})
        r1 = conn.getresponse()
        body1 = json.loads(r1.read())
        assert r1.status == 200 and r1.version == 11 and not r1.will_close
        sock = conn.sock
        conn.request("POST", "/predict", b"abc",
                     {"Content-Type": "application/octet-stream"})
        r2 = conn.getresponse()
        assert r2.status == 400
        json.loads(r2.read())
        assert conn.sock is sock
        conn.request("POST", "/predict", img.tobytes(),
                     {"Content-Type": "application/octet-stream"})
        r3 = conn.getresponse()
        assert r3.status == 200 and json.loads(r3.read()) == body1
    finally:
        conn.close()


def test_http_body_guards_and_backlog(session):
    """A truncated body 400, an absurd Content-Length 413, a stalled
    upload 408 after the read timeout; the server serves on; its listen
    backlog is sized for bursts."""
    with serving(session, read_timeout=1.0) as base:
        port = int(base.rsplit(":", 1)[1])
        row = SIZE * SIZE * 3

        def raw_post(body: bytes, claimed: int, stall: bool = False) -> int:
            s = socket.create_connection(("127.0.0.1", port), timeout=30)
            try:
                s.sendall((f"POST /predict HTTP/1.1\r\nHost: x\r\n"
                           f"Content-Length: {claimed}\r\nContent-Type: "
                           f"application/octet-stream\r\n\r\n").encode()
                          + body)
                if not stall:
                    s.shutdown(socket.SHUT_WR)
                return int(s.recv(64).split(b" ")[1])
            finally:
                s.close()

        assert raw_post(b"\0" * 100, row) == 400
        assert raw_post(b"", 1 << 29) == 413
        assert raw_post(b"\0" * 100, row, stall=True) == 408
        code, got = request(base + "/predict", pixels(1, seed=13)[0]
                            .tobytes())
        assert code == 200 and got["class"] in ("benign", "malignant")
    server = make_http_server(DynamicBatcher(session), port=0)
    try:
        assert server.request_queue_size == 4 * max(64, session.max_batch)
    finally:
        server.server_close()


def test_http_concurrent_requests_coalesce(session):
    images = pixels(12, seed=5)
    session.warm()
    ref = session.predict(images)
    with serving(session, window_ms=200.0) as base:
        results, errors = {}, []

        def hit(i):
            try:
                results[i] = request(base + "/predict",
                                     images[i].tobytes())[1]
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors
        for i in range(12):
            assert results[i]["pred"] == int(ref["pred"][i])
        _, after = request(base + "/stats")
        assert after["requests"] == 12 and after["batches"] < 12
        assert after["max_coalesced"] >= 2


# -- hot reload -------------------------------------------------------------


def _snapshot(sess) -> dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in sess._weights.items()}


def _assert_untouched(sess, before: dict[str, torch.Tensor]) -> None:
    assert sess.reloads == 0
    for k, v in sess._weights.items():
        assert torch.equal(v, before[k]), k


def test_hot_reload_follows_jax(tmp_path):
    folder = jax_folder(tmp_path / "exp", FLAGSHIP, seed=1)
    jsess = jserver.InferenceSession.from_experiment(folder, max_batch=4)
    sess = InferenceSession.from_experiment(folder, max_batch=4,
                                            device="cpu")
    px = pixels(3, seed=20)
    before = sess.predict(px)
    jax_folder(folder, FLAGSHIP, seed=2)  # the trainer writes anew
    assert sess.reload_weights() == jsess.reload_weights()
    assert sess.reloads == 1
    after = sess.predict(px)
    assert not np.allclose(before["log_probs"], after["log_probs"])
    assert_same_answers(after, jsess.predict(px))
    fresh = InferenceSession.from_experiment(folder, device="cpu")
    np.testing.assert_array_equal(after["log_probs"],
                                  fresh.predict(px)["log_probs"])


def test_hot_reload_refusals_leave_weights_bit_identical(tmp_path,
                                                         monkeypatch):
    folder = jax_folder(tmp_path / "exp", FLAGSHIP, seed=1)
    sess = InferenceSession.from_experiment(folder, max_batch=4,
                                            device="cpu")
    px = pixels(2, seed=21)
    before, weights = sess.predict(px), _snapshot(sess)

    other = jax_folder(tmp_path / "other", dict(FLAGSHIP,
                                                conv_features=(8, 8)), 3)
    with pytest.raises(ValueError, match="architecture differs"):
        sess.reload_weights(other)
    normed = jax_folder(tmp_path / "normed", FLAGSHIP, 4,
                        {"data": {"normalize_imagenet": True}})
    with pytest.raises(ValueError, match="normalize_imagenet"):
        sess.reload_weights(normed)
    affine = jax_folder(tmp_path / "affine", FLAGSHIP, 5,
                        {"data": {"input_affine": AFFINE}})
    with pytest.raises(ValueError, match="input_affine"):
        sess.reload_weights(affine)
    with pytest.raises(FileNotFoundError):
        sess.reload_weights(str(tmp_path / "missing"))

    # the same ModelConfig but a last tensor of another shape: the whole
    # state_dict is checked before the first copy
    real_load = tckpt.load_model

    def reshaped(path):
        cfg, sd = real_load(path)
        last = list(sd)[-1]
        sd[last] = torch.zeros(sd[last].shape[0] + 1)
        return cfg, sd

    jax_folder(folder, FLAGSHIP, seed=6)
    monkeypatch.setattr(tckpt, "load_model", reshaped)
    with pytest.raises(ValueError, match="do not fit"):
        sess.reload_weights()
    monkeypatch.setattr(tckpt, "load_model", lambda p: (
        real_load(p)[0], {k: v.double() for k, v in real_load(p)[1].items()}))
    with pytest.raises(ValueError, match="do not fit"):
        sess.reload_weights()
    monkeypatch.undo()

    with open(os.path.join(folder, tckpt.MODEL_FILENAME), "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.raises(ValueError):
        sess.reload_weights()
    _assert_untouched(sess, weights)
    np.testing.assert_array_equal(before["log_probs"],
                                  sess.predict(px)["log_probs"])


def test_hot_reload_checks_convention_without_train_config(tmp_path):
    src = jax_folder(tmp_path / "exp", FLAGSHIP, 1,
                     {"data": {"input_affine": [[2.0] * 3, [-1.0] * 3]}})
    sess = InferenceSession.from_experiment(src, max_batch=4, device="cpu")
    assert sess._input_affine is not None
    weights = _snapshot(sess)
    bare = jax_folder(tmp_path / "bare", FLAGSHIP, 2)
    with pytest.raises(ValueError, match="input_affine"):
        sess.reload_weights(bare)
    _assert_untouched(sess, weights)


def test_session_applies_input_affine(folders, sessions):
    """The affine folder's program equals a direct forward on
    ``x / 128 - 1``."""
    sess = sessions["affine"][1]
    px = pixels(2, seed=5)
    cfg, state_dict = tckpt.load_model(os.path.join(
        folders["affine"], tckpt.MODEL_FILENAME))
    net = build_model(cfg, device="cpu")
    net.load_state_dict(state_dict)
    with torch.no_grad():
        want = net(torch.from_numpy(px).float() / 128.0 - 1.0).numpy()
    np.testing.assert_allclose(sess.predict(px)["log_probs"], want,
                               atol=1e-5)


def test_http_reload_endpoint(tmp_path):
    folder = jax_folder(tmp_path / "exp", FLAGSHIP, seed=1)
    other = jax_folder(tmp_path / "other", FLAGSHIP, seed=6)
    wide = jax_folder(tmp_path / "wide", dict(FLAGSHIP,
                                              conv_features=(8, 8)), 7)
    sess = InferenceSession.from_experiment(folder, max_batch=4,
                                            device="cpu")
    img = pixels(1, seed=23)[0].tobytes()
    with serving(sess) as base:
        _, r1 = request(base + "/predict", img)
        jax_folder(folder, FLAGSHIP, seed=5)
        code, got = request(base + "/reload", b"", "application/json")
        assert code == 200 and got["status"] == "reloaded"
        assert got["reloads"] == 1
        _, r2 = request(base + "/predict", img)
        assert r2["log_probs"] != r1["log_probs"]
        assert request(base + "/healthz")[1]["reloads"] == 1
        body = json.dumps({"folder": other}).encode()
        assert request(base + "/reload", body, "application/json")[0] == 403
        # the source folder named explicitly is no other folder
        same = json.dumps({"folder": folder}).encode()
        assert request(base + "/reload", same, "application/json")[0] == 200
    with serving(sess, reload_any=True) as base:
        weights = _snapshot(sess)
        wide_body = json.dumps({"folder": wide}).encode()
        code, _ = request(base + "/reload", wide_body, "application/json")
        assert code == 409
        for k, v in sess._weights.items():
            assert torch.equal(v, weights[k])
        missing = json.dumps({"folder": str(tmp_path / "none")}).encode()
        assert request(base + "/reload", missing,
                       "application/json")[0] == 404
        body = json.dumps({"folder": other}).encode()
        code, got = request(base + "/reload", body, "application/json")
        assert code == 200 and got["reloads"] == 3
        px = pixels(2, seed=24)
        ref = jserver.InferenceSession.from_experiment(other).predict(px)
        assert_same_answers(sess.predict(px), ref)


def _wait(pred, seconds: float = 20.0) -> None:
    deadline = time.time() + seconds
    while not pred() and time.time() < deadline:
        time.sleep(0.05)


def test_reload_watcher_auto_swaps(tmp_path):
    folder = jax_folder(tmp_path / "exp", FLAGSHIP, seed=1)
    sess = InferenceSession.from_experiment(folder, max_batch=4,
                                            device="cpu")
    px = pixels(2, seed=30)
    before = sess.predict(px)
    thread, stop = start_reload_watcher(sess, interval_s=0.05,
                                        verbose=False)
    try:
        jax_folder(folder, FLAGSHIP, seed=8)
        _wait(lambda: sess.reloads >= 1)
        assert sess.reloads == 1
        after = sess.predict(px)
        assert not np.allclose(before["log_probs"], after["log_probs"])
        with open(os.path.join(folder, tckpt.MODEL_FILENAME), "wb") as f:
            f.write(b"junk")
        time.sleep(0.3)
        assert sess.reloads == 1
        np.testing.assert_array_equal(after["log_probs"],
                                      sess.predict(px)["log_probs"])
    finally:
        stop.set()
        thread.join(timeout=5)


def test_reload_watcher_tracks_best_file(tmp_path):
    """A --best session's watcher follows session_model_best.msgpack only,
    and serves what the JAX --best session serves."""
    folder = jax_folder(tmp_path / "exp", FLAGSHIP, seed=1)
    shutil.copy(os.path.join(folder, tckpt.MODEL_FILENAME),
                os.path.join(folder, tckpt.BEST_MODEL_FILENAME))
    sess = InferenceSession.from_experiment(
        folder, max_batch=4, model_filename=tckpt.BEST_MODEL_FILENAME,
        device="cpu")
    assert sess.model_filename == tckpt.BEST_MODEL_FILENAME
    px = pixels(2, seed=31)
    before = sess.predict(px)
    thread, stop = start_reload_watcher(sess, interval_s=0.05,
                                        verbose=False)
    try:
        jax_folder(folder, FLAGSHIP, seed=9)  # the final file only
        time.sleep(0.5)
        assert sess.reloads == 0
        other = jax_folder(tmp_path / "other", FLAGSHIP, seed=10)
        os.replace(os.path.join(other, tckpt.MODEL_FILENAME),
                   os.path.join(folder, tckpt.BEST_MODEL_FILENAME))
        _wait(lambda: sess.reloads >= 1)
        assert sess.reloads == 1
        after = sess.predict(px)
        assert not np.allclose(before["log_probs"], after["log_probs"])
        assert_same_answers(after, jserver.InferenceSession.from_experiment(
            folder, model_filename=jckpt.BEST_MODEL_FILENAME).predict(px))
    finally:
        stop.set()
        thread.join(timeout=5)


def test_prefer_warm_bucket_and_background_converge(folders):
    sess = InferenceSession.from_experiment(folders["flagship"],
                                            max_batch=8, device="cpu")
    sess.warm([1, 8])
    assert sess.compiled == {1, 8}
    fg, bg = [], []
    real, main = sess._program, threading.current_thread()

    def spy(x):
        (fg if threading.current_thread() is main else bg).append(
            x.shape[0])
        return real(x)

    sess._program = spy
    px = pixels(3, seed=5)
    out = sess.predict(px)
    assert fg == [8]  # served on the warm 8-bucket, not a cold 4
    _wait(lambda: 4 in sess.compiled, 60)
    assert 4 in sess.compiled and bg == [4]
    fg.clear()
    np.testing.assert_allclose(out["log_probs"],
                               sess.predict(px)["log_probs"], atol=1e-6)
    assert fg == [4]
    cold = InferenceSession.from_experiment(folders["flagship"],
                                            max_batch=8, device="cpu")
    cold.warm([1])
    cold.predict(px)
    assert 4 in cold.compiled


def test_entry_points_default_to_the_card(folders):
    """Without ``device="cpu"`` the session wants the card, and raises
    where there is none: no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceSession.from_experiment(folders["flagship"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tone_bias_serve.main([folders["flagship"], "--no-warm"])


# -- the serve CLI ----------------------------------------------------------


def test_serve_cli_usage_and_refusals(folders, tmp_path, capsys):
    assert tone_bias_serve.main([]) == 1
    assert "Usage" in capsys.readouterr().out
    folder = folders["flagship"]
    # --mesh 2 (once refused until ROADMAP item 12) serves the folder data
    # parallel: two replicas, the ladder's multiples of 2
    served = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tserver, "serve_http",
                   lambda batcher, **kw: served.append(batcher))
        assert tone_bias_serve.main([folder, "--device", "cpu", "--mesh",
                                     "2", "--max-batch", "8"]) == 0
    [batcher] = served
    batcher.stop()
    session = batcher.session
    assert dict(session.mesh.shape) == {"data": 2, "model": 1}
    assert session.buckets == [2, 4, 8] and session.compiled == {2, 4, 8}
    assert_same_answers(session.predict(pixels(5)), InferenceSession
                        .from_experiment(folder, device="cpu")
                        .predict(pixels(5)))
    for flags in (["--quantize", "int8", "--calib-root", "x"], []):
        art = folder if flags else str(tmp_path / "m.pt2")
        with pytest.raises(SystemExit, match="--mesh"):
            tone_bias_serve.main([art, "--device", "cpu", "--mesh", "2",
                                  *flags])
    # --quantize is served (tests/test_torch_quantize.py); its guards
    for flags, said in ((["--quantize", "int8-weights"], "unknown"),
                        (["--quantize", "int8"], "--calib-root"),
                        (["--quantize", "int8", "--calib-root", "x",
                          "--watch", "5"], "exclusive with --watch")):
        with pytest.raises(SystemExit, match=said):
            tone_bias_serve.main([folder, "--device", "cpu", *flags])
    for flag in ("--max-rss-mb", "--listen-fd", "--ready-fd"):
        with pytest.raises(SystemExit, match="by design"):
            tone_bias_serve.main([folder, "--device", "cpu", flag, "3"])
    art = tmp_path / "m.pt2"
    art.write_bytes(b"not a program")
    with pytest.raises(SystemExit, match="experiment folders"):
        tone_bias_serve.main([str(art), "--best", "--device", "cpu"])
    with pytest.raises(SystemExit, match="experiment folders"):
        tone_bias_serve.main([str(art), "--quantize", "int8",
                              "--calib-root", "x", "--device", "cpu"])
    with pytest.raises(SystemExit, match="keep-best"):
        tone_bias_serve.main([folder, "--best", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown flag"):
        tone_bias_serve.main([folder, "--bogus"])


def test_serve_and_export_without_jax(tmp_path):
    """A port-written folder exported by ``tone_bias_export`` and served by
    ``tone_bias_serve`` (folder and artifact, raw and PNG ``/predict``,
    ``/reload``) with jax, flax, optax and the JAX package unimportable."""
    folder = str(tmp_path / "exp")
    os.makedirs(folder)
    cfg = tconfig.ModelConfig(**FLAGSHIP)
    tckpt.save_model(os.path.join(folder, tckpt.MODEL_FILENAME), cfg,
                     build_model(cfg, device="cpu").state_dict())
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    code = textwrap.dedent(f"""
        import json, sys, threading, time, urllib.request
        import numpy as np
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {_BLOCKED!r}:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import torch
        torch.set_num_threads(1)
        from skin_image_analysis_tpu_torch.cli import (
            tone_bias_export, tone_bias_serve)
        out = {str(tmp_path / "m.pt2")!r}
        assert tone_bias_export.main([{folder!r}, out, "--device",
                                      "cpu"]) == 0
        for src, port in (({folder!r}, {ports[0]}), (out, {ports[1]})):
            threading.Thread(target=tone_bias_serve.main, daemon=True,
                             args=([src, "--port", str(port), "--max-batch",
                                    "4", "--device", "cpu"],)).start()
        def call(port, path, data=None, ctype="application/octet-stream"):
            url = f"http://127.0.0.1:{{port}}{{path}}"
            for _ in range(600):
                try:
                    req = urllib.request.Request(
                        url, data=data, headers={{"Content-Type": ctype}})
                    with urllib.request.urlopen(req, timeout=30) as r:
                        return json.loads(r.read())
                except urllib.error.HTTPError:
                    raise
                except OSError:
                    time.sleep(0.1)
            raise AssertionError("no server on " + str(port))
        import cv2
        img = np.random.default_rng(0).integers(0, 256, (16, 16, 3),
                                                np.uint8)
        ok, png = cv2.imencode(".png", img[:, :, ::-1])
        a = call({ports[0]}, "/predict", img.tobytes())
        b = call({ports[1]}, "/predict", img.tobytes())
        c = call({ports[0]}, "/predict", png.tobytes(), "image/png")
        assert a == c and a["pred"] == b["pred"], (a, b, c)
        assert np.allclose(a["log_probs"], b["log_probs"], atol=1e-5)
        assert call({ports[0]}, "/reload", b"")["reloads"] == 1
        assert call({ports[1]}, "/healthz")["buckets"] == [1, 2, 4]
        assert not [m for m in sys.modules
                    if m.split(".")[0] in {_BLOCKED!r}]
        print("ok", a["class"])
    """)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "exported" in out.stdout and "warm done" in out.stdout
    assert "\nok " in out.stdout
