"""The port's HTTP bundle server, its coalescer and the export and serve
drivers, on the CPU (the JAX package's server tests, tests/test_serving.py,
with the port's bundles).

The HTTP tests serve a real ``single`` bundle of a one-weight stand-in
model; the coalescer tests use fake paired bundles that record each device
call (and, for the pipelining tests, return lazy results whose fetch
blocks), as the JAX package's tests do.
"""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dctseg.data.brats import zscore_nonzero as jax_zscore_nonzero

from dctseg_torch.cli import export_serving, serve
from dctseg_torch.config import ModelConfig
from dctseg_torch.data.stats import zscore_nonzero
from dctseg_torch.infer import server as server_mod
from dctseg_torch.infer.engine import Predictor
from dctseg_torch.infer.server import BundleServer, serve_bundle
from dctseg_torch.infer.serving import ServingBundle, export_bundle
from dctseg_torch.models.clswiseformer import build_model
from dctseg_torch.train.checkpoint import Checkpointer
from dctseg_torch.utils.proctitle import set_process_title

SHAPE = (8, 8, 8)


class _Offset(torch.nn.Module):
    """'probs' = the input plus a per-channel offset (position-coded)."""

    def __init__(self):
        super().__init__()
        self.register_buffer("offset", torch.tensor([0.0, 0.1, 0.2, 0.3]))

    def forward(self, x):
        return (x.float() + self.offset,)


def _http(url, body=None):
    req = urllib.request.Request(url, data=body,
                                 method="POST" if body else "GET")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, dict(r.headers), r.read()


def _http_err(url, body=None):
    req = urllib.request.Request(url, data=body,
                                 method="POST" if body else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30):
            raise AssertionError("expected an HTTP error")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr))
    return buf.getvalue()


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("srv") / "bundle")
    export_bundle(Predictor(_Offset(), device="cpu"), out, strategy="single",
                  input_shape=SHAPE)
    return out


@pytest.fixture(scope="module")
def served(bundle_dir):
    bundle = ServingBundle.load(bundle_dir, device="cpu")
    server = BundleServer(bundle, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    x = np.random.default_rng(0).normal(size=(1, *SHAPE, 4)).astype(
        np.float32)
    yield f"http://127.0.0.1:{server.port}", bundle, x
    server.shutdown()


def test_server_health_and_manifest(served):
    base, bundle, _ = served
    status, _, body = _http(base + "/healthz")
    health = json.loads(body)
    assert status == 200 and health["status"] == "ok"
    assert health["strategy"] == "single"
    status, _, body = _http(base + "/v1/manifest")
    assert status == 200 and json.loads(body) == bundle.manifest


def test_server_predict_labels_and_probs(served):
    base, bundle, x = served
    status, headers, body = _http(base + "/v1/predict", _npy_bytes(x))
    assert status == 200
    assert headers["Content-Type"] == "application/x-npy"
    assert "X-Latency-Ms" in headers
    labels = np.load(io.BytesIO(body))
    assert labels.dtype == np.uint8
    np.testing.assert_array_equal(labels, bundle.labels(x).numpy())
    # a big-endian body gets the same answer
    _, _, body = _http(base + "/v1/predict", _npy_bytes(x.astype(">f4")))
    np.testing.assert_array_equal(np.load(io.BytesIO(body)), labels)
    # probs output, and a 4-D body (no leading batch dim) is accepted
    status, _, body = _http(base + "/v1/predict?output=probs",
                            _npy_bytes(x[0]))
    np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                  bundle.predict(x).numpy())


def test_server_preprocess_applies_pipeline_zscore(served):
    """preprocess=1 z-scores each modality over the nonzero voxels of the
    whole volume: the data pipeline's normalisation, the port's and the
    JAX package's alike."""
    base, bundle, x = served
    rng = np.random.default_rng(7)
    raw = (rng.uniform(50, 500, size=x.shape).astype(np.float32)
           * (rng.uniform(size=x.shape) > 0.3))  # zeros stay background
    status, _, body = _http(base + "/v1/predict?output=probs&preprocess=1",
                            _npy_bytes(raw))
    assert status == 200
    normed = zscore_nonzero(raw[0])[None]
    np.testing.assert_allclose(normed[0], jax_zscore_nonzero(raw[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                  bundle.predict(normed).numpy())


def test_server_rejects_bad_requests(served):
    base, _, x = served
    code, err = _http_err(base + "/v1/predict",
                          _npy_bytes(np.zeros((1, 4, 4, 4, 4), np.float32)))
    assert code == 400 and "shape" in err["error"]
    code, err = _http_err(base + "/v1/predict", b"not an npy payload")
    assert code == 400 and "npy" in err["error"]
    code, err = _http_err(base + "/v1/predict?output=midi", _npy_bytes(x))
    assert code == 400 and "output" in err["error"]
    code, err = _http_err(base + "/v1/predict",
                          _npy_bytes(np.full(x.shape, "a")))
    assert code == 400 and "dtype" in err["error"]
    code, _ = _http_err(base + "/nope")
    assert code == 404
    code, _ = _http_err(base + "/v1/other", _npy_bytes(x))
    assert code == 404


def test_to_host_takes_tensors_and_arrays():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    np.testing.assert_array_equal(server_mod._to_host(t), t.numpy())
    np.testing.assert_array_equal(server_mod._to_host(t.numpy()), t.numpy())
    assert server_mod._ready_event(t) is None


# ---- the coalescer ----


class _FakePairedBundle:
    """Stands in for a paired ServingBundle (batch_volumes=V): records the
    batch shape of every device call and returns a per-volume fingerprint,
    so that each client can be checked to get its own volume's answer."""

    strategy = "tiling"

    def __init__(self, v=3, shape=(4, 4, 4), ch=2):
        self.manifest = {"batch_volumes": v, "input_shape": list(shape),
                         "in_channels": ch, "input_dtype": "float32",
                         "strategy": "tiling"}
        self.calls = []

    def labels(self, x):
        x = np.asarray(x)
        self.calls.append(x.shape)
        time.sleep(0.05)  # device time: lets concurrent clients pile up
        return _fingerprint(x)

    predict = labels


def _fingerprint(x):
    return np.round(x.mean(axis=(1, 2, 3, 4))[:, None, None, None]
                    * 100).astype(np.int32) * np.ones((1, 2, 2, 2), np.int32)


def _serve_coalescing(fake, wait_s):
    server = BundleServer(fake, port=0, warmup=False,
                          coalesce_wait_s=wait_s)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.port}"


def _post_predict(base, vol, output="labels"):
    req = urllib.request.Request(base + f"/v1/predict?output={output}",
                                 data=_npy_bytes(vol), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return np.load(io.BytesIO(r.read()))


def _post_all(base, vols, outputs=None):
    results = [None] * len(vols)

    def post(i):
        results[i] = _post_predict(base, vols[i],
                                   outputs[i] if outputs else "labels")

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(vols))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return results


def test_server_coalesces_concurrent_single_volume_requests():
    """Concurrent single-volume clients on a paired bundle run as ONE
    padded B=8V program, and each client gets its own volume's answer."""
    fake = _FakePairedBundle(v=3)
    server, base = _serve_coalescing(fake, 0.5)
    try:
        rng = np.random.default_rng(0)
        vols = [rng.normal(size=(1, 4, 4, 4, 2)).astype(np.float32)
                for _ in range(3)]
        for vol, got in zip(vols, _post_all(base, vols)):
            np.testing.assert_array_equal(got, _fingerprint(vol))
        assert fake.calls == [(3, 4, 4, 4, 2)], fake.calls
        # a lone request still completes (a padded partial group) ...
        fake.calls.clear()
        _post_predict(base, vols[0])
        assert fake.calls == [(3, 4, 4, 4, 2)]
        # ... and a whole-group request takes the direct path
        out = _post_predict(base, np.concatenate(vols, axis=0))
        assert out.shape == (3, 2, 2, 2)
        status, _, body = _http(base + "/healthz")
        health = json.loads(body)
        assert status == 200 and health["coalesce_volumes"] == 3
        assert health["last_group_size"] >= 1
    finally:
        server.shutdown()


class _LazyOut:
    """An asynchronous result: ``np.asarray`` (the fetch) blocks for
    ``delay``, so tests can see whether dispatch overlaps the fetch."""

    def __init__(self, arr, delay, on_fetch):
        self._arr, self._delay, self._on_fetch = arr, delay, on_fetch

    def __array__(self, dtype=None, copy=None):
        time.sleep(self._delay)
        self._on_fetch(time.monotonic())
        return self._arr if dtype is None else self._arr.astype(dtype)


class _AsyncFakeBundle(_FakePairedBundle):
    """Paired bundle whose calls return at once with a lazy result whose
    fetch costs ``fetch_delay``; records dispatch and fetch times."""

    def __init__(self, v=2, fetch_delay=0.3):
        super().__init__(v=v)
        self.fetch_delay = fetch_delay
        self.dispatch_times = []
        self.fetch_done_times = []

    def labels(self, x):
        x = np.asarray(x)
        self.calls.append(x.shape)
        self.dispatch_times.append(time.monotonic())
        return _LazyOut(_fingerprint(x), self.fetch_delay,
                        self.fetch_done_times.append)

    predict = labels


def test_coalescer_mixed_output_group_dispatches_both_before_fetch():
    """A mixed labels/probs group enqueues both programs before the first
    fetch completes."""
    fake = _AsyncFakeBundle(v=2, fetch_delay=0.4)
    server, base = _serve_coalescing(fake, 0.5)
    try:
        vol = np.random.default_rng(0).normal(
            size=(1, 4, 4, 4, 2)).astype(np.float32)
        results = _post_all(base, [vol, vol], ["labels", "probs"])
        assert all(r.shape == (1, 2, 2, 2) for r in results)
        assert len(fake.dispatch_times) == len(fake.fetch_done_times) == 2
        assert fake.dispatch_times[1] < min(fake.fetch_done_times), (
            fake.dispatch_times, fake.fetch_done_times)
    finally:
        server.shutdown()


def test_coalescer_pipelines_across_groups():
    """Group i+1's program is dispatched while group i's fetch is still
    pending (depth-2 pipeline)."""
    fake = _AsyncFakeBundle(v=2, fetch_delay=0.5)
    server, base = _serve_coalescing(fake, 0.15)
    try:
        rng = np.random.default_rng(1)
        vols = [rng.normal(size=(1, 4, 4, 4, 2)).astype(np.float32)
                for _ in range(4)]
        for vol, got in zip(vols, _post_all(base, vols)):
            np.testing.assert_array_equal(got, _fingerprint(vol))
        assert len(fake.dispatch_times) == 2, fake.calls
        assert fake.dispatch_times[1] < min(fake.fetch_done_times), (
            fake.dispatch_times, fake.fetch_done_times)
    finally:
        server.shutdown()


def test_coalescer_stop_fails_stranded_submitters_fast():
    """A submit racing stop() gets a prompt answer, not the 5 s liveness
    poll; a submit after stop() raises at once."""
    fake = _FakePairedBundle(v=2)
    server = BundleServer(fake, port=0, warmup=False, coalesce_wait_s=5.0)
    co = server._coalescer
    vol = np.zeros((1, 4, 4, 4, 2), np.float32)
    outcome = {}

    def submitter():
        try:
            co.submit(vol, "labels")
            outcome["ok"] = True
        except RuntimeError as e:
            outcome["err"] = str(e)

    # the submitter waits inside the 5 s coalesce window (a group of 1 on
    # a V=2 bundle) when stop() lands
    th = threading.Thread(target=submitter)
    th.start()
    time.sleep(0.2)
    t_stop = time.monotonic()
    server.shutdown()
    th.join(timeout=10)
    assert not th.is_alive()
    assert time.monotonic() - t_stop < 3.0
    assert outcome.get("ok") or "stopped" in outcome.get("err", "")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="stopped"):
        co.submit(vol, "labels")
    assert time.monotonic() - t0 < 1.0


def test_coalescer_device_failure_fans_out_and_server_survives():
    """A failure while assembling or running a coalesced group reaches the
    waiting clients as HTTP 500, and the dispatcher serves the next one."""

    class _ExplodingBundle(_FakePairedBundle):
        def __init__(self):
            super().__init__(v=2)
            self.fail_next = True

        def labels(self, x):
            if self.fail_next:
                self.fail_next = False
                raise MemoryError("forced group failure (test)")
            return super().labels(x)

        predict = labels

    server, base = _serve_coalescing(_ExplodingBundle(), 0.1)
    try:
        vol = np.zeros((1, 4, 4, 4, 2), np.float32)
        code, err = _http_err(base + "/v1/predict", _npy_bytes(vol))
        assert code == 500 and "MemoryError" in err["error"]
        assert _post_predict(base, vol).shape == (1, 2, 2, 2)
    finally:
        server.shutdown()


@pytest.mark.parametrize("v", [1, 2], ids=["direct", "coalesced"])
def test_every_program_runs_on_the_one_device_thread(v):
    """The warm-up and every request's program run on one thread, not the
    caller's nor a handler's: cuDNN's conv plans are kept per thread, so
    the warm-up's search then serves every request."""

    class _Threaded(_FakePairedBundle):
        def labels(self, x):
            self.threads.append(threading.get_ident())
            return super().labels(x)

        predict = labels

    fake = _Threaded(v=v)
    fake.threads = []
    server = BundleServer(fake, port=0, coalesce_wait_s=0.05)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        vols = [np.full((1, 4, 4, 4, 2), i, np.float32) for i in range(2)]
        got = _post_all(f"http://127.0.0.1:{server.port}", vols,
                        ["labels", "probs"])
        for vol, out in zip(vols, got):
            np.testing.assert_array_equal(out, _fingerprint(vol))
    finally:
        server.shutdown()
    assert len(fake.threads) >= 2 and len(set(fake.threads)) == 1
    assert fake.threads[0] != threading.get_ident()


# ---- the drivers ----


def test_serve_cli_parse_and_helper(bundle_dir, monkeypatch):
    a = serve.parse_args(["--bundle", "b", "--port", "0", "--no-warmup"])
    assert (a.bundle, a.port, a.no_warmup, a.device) == ("b", 0, True,
                                                         "cuda")
    server = serve_bundle(bundle_dir, port=0, device="cpu", warmup=False)
    try:
        assert server.port > 0 and server.bundle.strategy == "single"
    finally:
        server.shutdown()
    # without a card, the default device raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_bundle(bundle_dir, port=0, warmup=False)


def test_export_serving_cli_random_params(tmp_path):
    out = str(tmp_path / "cli_bundle")
    rc = export_serving.main(
        ["--out", out, "--strategy", "single", "--random-params",
         "--device", "cpu", "--img-dim", "32", "--base-channels", "4",
         "--fp32", "--input-shape", "32", "32", "32"])
    assert rc == 0
    bundle = ServingBundle.load(out, device="cpu")
    y = bundle.predict(np.zeros((1, 32, 32, 32, 4), np.float32))
    assert y.shape == (1, 32, 32, 32, 4) and torch.isfinite(y).all()


def test_export_serving_cli_int8_paired_composition(tmp_path):
    """JAX's test of the same name: --quantize int8 x --batch-volumes 2 x
    --input-dtype float16 export one bundle, which loads and predicts; its
    labels are the live int8 engine's (the CLI's seed-0 weights), and
    its forward program holds the int8 operators."""
    out = str(tmp_path / "cli_int8_paired")
    rc = export_serving.main(
        ["--out", out, "--strategy", "single", "--random-params",
         "--device", "cpu", "--img-dim", "32", "--base-channels", "4",
         "--quantize", "int8", "--batch-volumes", "2",
         "--input-dtype", "float16", "--input-shape", "32", "32", "32"])
    assert rc == 0
    bundle = ServingBundle.load(out, device="cpu")
    m = bundle.manifest
    assert m["batch_volumes"] == 2 and m["input_dtype"] == "float16"
    x = np.random.default_rng(11).normal(size=(2, 32, 32, 32, 4)).astype(
        np.float32)
    y = bundle.predict(x)
    assert y.shape == (2, 32, 32, 32, 4) and torch.isfinite(y).all()
    model = build_model(ModelConfig(img_dim=32, base_channels=4, top_num=8,
                                    quantize="int8"), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    live = Predictor(model, device="cpu").seg_probs(
        torch.from_numpy(x).half())
    assert torch.equal(bundle.labels(x), torch.argmax(live, -1).to(
        torch.uint8))
    targets = [n.target for n in bundle._p["forward"].graph.nodes
               if n.op == "call_function"]
    # the three conv_semantic convs of the tiny direct model, which share
    # one quantization of their input
    assert targets.count(torch.ops.dctseg.int8_conv3d.default) == 3
    assert targets.count(torch.ops.dctseg.quantize_absmax.default) == 1


def test_export_serving_cli_needs_a_checkpoint(tmp_path, capsys,
                                              monkeypatch):
    """Without --random-params it embeds the newest epoch of
    --checkpoint-dir; with none there it exits 1, quantized or not, and a
    misspelt --quantize raises.  Without --device it exports on the card,
    and raises without one."""
    args = ["--out", str(tmp_path / "b"), "--img-dim", "16",
            "--base-channels", "2", "--checkpoint-dir", str(tmp_path / "ckpt")]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_serving.main(args + ["--random-params"])
    args += ["--device", "cpu"]
    assert export_serving.main(args) == 1
    assert "no checkpoint found" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "b")
    assert export_serving.main(args + ["--quantize", "int8"]) == 1
    with pytest.raises(ValueError, match="unknown quantize spec"):
        export_serving.main(args + ["--quantize", "int4", "--random-params"])
    # a saved epoch that does not fit the model is refused, not exported
    Checkpointer(str(tmp_path / "ckpt")).save(3, {"w": torch.zeros(1)}, {}, 0)
    with pytest.raises(RuntimeError, match="state_dict"):
        export_serving.main(args)


def test_set_process_title():
    with open("/proc/self/comm") as f:
        before = f.read().strip()
    try:
        assert set_process_title("dctseg-serve:8000-and-more")
        with open("/proc/self/comm") as f:
            assert f.read().strip() == "dctseg-serve:80"   # 15 characters
    finally:
        set_process_title(before)
