"""HTTP serving host over serving bundles (``dctseg_torch/infer/serving.py``;
the JAX package's ``dctseg/infer/server.py``, with its protocol).

A long-lived process loads one bundle (programs and weights, no model code,
no checkpoint) and answers volume -> segmentation over HTTP.  The host side
is the standard library's ``http.server``; the device side is the bundle's
exported programs.

Protocol (v1, numpy ``.npy`` payloads):

- ``GET  /healthz``      -> ``{"status": "ok", "requests": N, ...}``
- ``GET  /v1/manifest``  -> the bundle's MANIFEST.json
- ``POST /v1/predict``   -> body: ``.npy`` of shape ``(D, H, W, M)`` or
  ``(1, D, H, W, M)`` matching the bundle's input spec; response: ``.npy``.
  Query: ``output=labels`` (default; uint8 argmax) or ``output=probs`` (the
  strategy's probabilities); ``preprocess=1`` applies the data pipeline's
  per-modality nonzero z-score (``dctseg_torch/data/stats.py``) so raw
  intensity volumes can be posted as they are.

One card serves every request: the handler threads decode and encode off
the card's critical path, but every program (the warm-up's, the direct
path's, the coalescer's groups) runs on the server's one device thread, so
concurrent clients queue for the card rather than interleave programs.
PyTorch keeps cuDNN's conv plans per thread, and a bundle's ``predict``
times each conv's candidates on a thread's first call of a shape
(``infer/engine.py`` ``measured_convs``): on the one device thread the
warm-up pays that search once, where a thread per request would pay it in
every request and could pick other algorithms, and so other bits.

A PAIRED bundle (exported with ``batch_volumes=V``) coalesces: single-volume
requests from concurrent clients are gathered for up to ``coalesce_wait_s``
and run as ONE padded B=8V forward.  A request that already carries V
volumes takes the direct path.  Coalesced groups are pipelined two deep: a
dispatcher thread enqueues a group's programs on the card and hands the
device tensors on; a fetcher thread copies them to the host once their
programs are done, while the dispatcher enqueues the next group.  A mixed
labels/probs group enqueues both programs before either is fetched.
"""

from __future__ import annotations

import io
import json
import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from dctseg_torch.infer.serving import ServingBundle

log = logging.getLogger("dctseg_torch.serve")

# Volumes are big (240x240x160x4 fp32 = 147 MB) but bounded; refuse
# anything past a generous ceiling so a bad client can't exhaust the host.
MAX_BODY_BYTES = 1 << 30


class RequestError(ValueError):
    """Client error -> HTTP 400 with a JSON message."""


def _decode_npy(body: bytes) -> np.ndarray:
    try:
        return np.load(io.BytesIO(body), allow_pickle=False)
    except Exception as e:  # noqa: BLE001 - anything here is a bad payload
        raise RequestError(f"body is not a valid .npy payload: {e}") from e


def _encode_npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def _ready_event(ys) -> Optional["torch.cuda.Event"]:
    """An event recorded behind the programs that make the CUDA tensor
    ``ys`` (None for anything else)."""
    if not (isinstance(ys, torch.Tensor) and ys.is_cuda):
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(ys.device))
    return ev


def _to_host(ys, ready=None, stream=None) -> np.ndarray:
    """``ys`` as a host array.  A CUDA tensor whose ``ready`` event is given
    is copied on ``stream`` once the event has fired, so the copy does not
    queue behind programs enqueued after it."""
    if not isinstance(ys, torch.Tensor):
        return np.asarray(ys)
    if ready is None:
        return ys.cpu().numpy()
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        return ys.cpu().numpy()


class _Coalescer:
    """Gathers single-volume requests into one padded paired-bundle call.

    Handler threads ``submit()`` a (1, ...) volume and block; a dispatcher
    thread drains the queue -- waiting up to ``max_wait_s`` after the first
    arrival for the group to fill to the bundle's V -- pads partial groups
    with zeros, enqueues ONE B=8V program per output mode on the server's
    device thread, and a fetcher thread copies the results to the host and
    fans the per-volume slices back out.

    ``_fetch_q`` has maxsize 1, bounding the in-flight window at one group
    dispatching and one group fetching.  Grad mode is per thread, so the
    fetcher enters ``torch.inference_mode()`` itself; the programs run under
    the bundle's own."""

    def __init__(self, server: "BundleServer", max_wait_s: float = 0.05):
        self.server = server
        self.v = int(server.bundle.manifest.get("batch_volumes", 1))
        self.max_wait_s = max_wait_s
        self.last_group_size = 0
        self._stopped = False
        # guards the (stopped-check, enqueue) pair in submit() against
        # stop(): queue order then puts every real item before the shutdown
        # sentinel, so the dispatcher's drain never strands a submitter
        self._submit_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._fetch_q: "queue.Queue" = queue.Queue(maxsize=1)
        device = getattr(server.bundle, "device", None)
        self._stream = (torch.cuda.Stream(device)
                        if device is not None and device.type == "cuda"
                        else None)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dctseg-coalescer")
        self._fetcher = threading.Thread(target=self._fetch_loop,
                                         daemon=True,
                                         name="dctseg-coalescer-fetch")
        self._thread.start()
        self._fetcher.start()

    def submit(self, x: np.ndarray, output: str) -> np.ndarray:
        item = {"x": x, "output": output, "ev": threading.Event()}
        with self._submit_lock:
            if self._stopped or not self._thread.is_alive():
                raise RuntimeError("coalescer is stopped")
            self._q.put(item)
        # bounded wait: if a coalescer thread dies, waiters must not hang
        while not item["ev"].wait(timeout=5.0):
            if not (self._thread.is_alive() and self._fetcher.is_alive()):
                raise RuntimeError("coalescer dispatcher died")
        if "err" in item:
            raise item["err"]
        return item["out"]

    def stop(self) -> None:
        """Refuse new submits and wait for the dispatcher's last group."""
        with self._submit_lock:
            self._stopped = True
            self._q.put(None)
        self._thread.join()

    @staticmethod
    def _fail(items, err) -> None:
        for g in items:
            if not g["ev"].is_set():
                g["err"] = err
                g["ev"].set()

    def _run(self) -> None:
        try:
            self._dispatch_loop()
        finally:
            # shut the fetcher down after its pending work, then fail any
            # items stranded behind the sentinel (the submit lock ensures
            # nothing is enqueued after this drain)
            self._fetch_q.put(None)
            err = RuntimeError("coalescer is stopped")
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    self._fail([item], err)

    def _dispatch_loop(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                return
            group = [first]
            # monotonic: a wall-clock step must not stretch or collapse
            # the coalesce window
            deadline = time.monotonic() + self.max_wait_s
            while len(group) < self.v:
                try:
                    nxt = self._q.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if nxt is None:      # shutdown raced a batch: finish it
                    self._q.put(None)
                    break
                group.append(nxt)
            self.last_group_size = len(group)
            self._dispatch_group(group)

    def _dispatch_group(self, group) -> None:
        """Enqueue the group's program(s); hand the device results to the
        fetcher.  A mixed group enqueues labels AND probs before either
        output is fetched."""
        pending = []
        for output in ("labels", "probs"):
            sub = [g for g in group if g["output"] == output]
            if not sub:
                continue
            # everything per group inside the try: a MemoryError
            # concatenating V ~147 MB volumes must fan out to the waiters,
            # not kill the dispatcher
            try:
                xs = np.concatenate([g["x"] for g in sub], axis=0)
                if xs.shape[0] < self.v:   # pad the partial group
                    xs = np.concatenate(
                        [xs, np.zeros(
                            (self.v - xs.shape[0], *xs.shape[1:]),
                            xs.dtype)], axis=0)
                pending.append((sub, *self.server._on_device(
                    self._enqueue, xs, output)))
            except Exception as e:  # noqa: BLE001 - fan out to waiters
                self._fail(sub, e)
        for item in pending:
            self._fetch_q.put(item)   # blocks at the depth-2 window

    def _enqueue(self, xs, output):
        """On the device thread: the group's program and an event behind
        it."""
        bundle = self.server.bundle
        ys = bundle.labels(xs) if output == "labels" else bundle.predict(xs)
        return ys, _ready_event(ys)

    def _fetch_loop(self) -> None:
        with torch.inference_mode():
            while True:
                got = self._fetch_q.get()
                if got is None:
                    return
                sub, ys, ready = got
                try:
                    out = _to_host(ys, ready, self._stream)
                    for j, g in enumerate(sub):
                        g["out"] = out[j:j + 1]
                except Exception as e:  # noqa: BLE001 - fan out to waiters
                    for g in sub:
                        g["err"] = e
                for g in sub:
                    g["ev"].set()


class BundleServer:
    """A ``ServingBundle`` behind a threaded standard-library HTTP server.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``serve_forever()`` blocks; ``shutdown()`` from another thread stops it.
    ``coalesce=None`` coalesces for paired bundles (batch_volumes > 1).
    """

    def __init__(self, bundle: ServingBundle, host: str = "127.0.0.1",
                 port: int = 8000, *, warmup: bool = True,
                 coalesce: Optional[bool] = None,
                 coalesce_wait_s: float = 0.05):
        self.bundle = bundle
        # every program on one thread (module docstring)
        self._device = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dctseg-device")
        self._requests = 0
        self._last_latency_s: Optional[float] = None
        self._started = time.time()
        v = int(bundle.manifest.get("batch_volumes", 1))
        use_coalesce = v > 1 if coalesce is None else (coalesce and v > 1)
        self._coalescer = (_Coalescer(self, coalesce_wait_s)
                           if use_coalesce else None)
        if warmup:
            self._warmup()
        handler = self._make_handler()
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._serving = False

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    def serve_forever(self) -> None:
        log.info("serving %s bundle on http://%s:%d (input %s %s)",
                 self.bundle.strategy, self.host, self.port,
                 self.bundle.manifest["input_shape"],
                 self.bundle.manifest["input_dtype"])
        self._serving = True
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        # BaseServer.shutdown() waits for the serve_forever loop to exit,
        # which only that loop signals: on a server that never served it
        # would wait forever
        if self._coalescer is not None:
            self._coalescer.stop()
        if self._serving:
            self._httpd.shutdown()
        self._httpd.server_close()
        self._device.shutdown()

    def _on_device(self, fn, *args):
        """``fn(*args)`` on the server's device thread, in arrival order."""
        return self._device.submit(fn, *args).result()

    def _warmup(self) -> None:
        """Run one labels() on zeros, so that the first client request
        finds the kernels built and the card's allocator warm."""
        m = self.bundle.manifest
        x = np.zeros((m.get("batch_volumes", 1), *m["input_shape"],
                      m["in_channels"]), np.dtype(m["input_dtype"]))
        t0 = time.time()
        self._on_device(lambda: _to_host(self.bundle.labels(x)))
        log.info("warmup predict: %.2f s", time.time() - t0)

    # -- request handling --------------------------------------------------

    def _predict(self, body: bytes, output: str,
                 preprocess: bool) -> Tuple[bytes, float]:
        x = _decode_npy(body)
        if x.ndim == 4:
            x = x[None]
        m = self.bundle.manifest
        v = m.get("batch_volumes", 1)
        coalescing = self._coalescer is not None and x.shape[0] == 1
        want = (1 if coalescing else v,
                *m["input_shape"], m["in_channels"])
        if tuple(x.shape) != want:
            raise RequestError(
                f"bundle expects input shape {(v, *want[1:])}"
                + (" (or without the leading 1)" if v == 1 else
                   f" — a paired bundle takes {v} volumes per request"
                   + (", or one volume at a time (server-side "
                      "coalescing)" if self._coalescer is not None
                      else "")) + f", got {tuple(x.shape)}")
        if not np.issubdtype(x.dtype, np.floating) and not np.issubdtype(
                x.dtype, np.integer):
            raise RequestError(f"unsupported input dtype {x.dtype}")
        if preprocess:
            from dctseg_torch.data.stats import zscore_nonzero
            x = np.stack([zscore_nonzero(x[i]) for i in range(x.shape[0])])
        t0 = time.time()
        if coalescing:
            out = self._coalescer.submit(x, output)
        else:
            run = (self.bundle.labels if output == "labels"
                   else self.bundle.predict)
            out = self._on_device(lambda: _to_host(run(x)))
        latency = time.time() - t0
        self._last_latency_s = latency
        return _encode_npy(out), latency

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route to our logger
                log.debug("%s - %s", self.address_string(), fmt % args)

            def _reply(self, code: int, payload: bytes,
                       ctype: str = "application/json",
                       extra_headers=()) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                for k, v in extra_headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def _reply_json(self, code: int, obj) -> None:
                self._reply(code, json.dumps(obj).encode())

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    health = {
                        "status": "ok",
                        "strategy": server.bundle.strategy,
                        "requests": server._requests,
                        "last_latency_s": server._last_latency_s,
                        "uptime_s": round(time.time() - server._started, 3),
                    }
                    if server._coalescer is not None:
                        health["coalesce_volumes"] = server._coalescer.v
                        health["last_group_size"] = \
                            server._coalescer.last_group_size
                    self._reply_json(200, health)
                elif path == "/v1/manifest":
                    self._reply_json(200, server.bundle.manifest)
                else:
                    self._reply_json(404, {"error": f"no route {path}"})

            def do_POST(self):
                url = urlparse(self.path)
                length = int(self.headers.get("Content-Length", 0))
                if length < 0 or length > MAX_BODY_BYTES:
                    # can't afford to drain this one: close the connection
                    self.close_connection = True
                    self._reply_json(
                        400, {"error": f"Content-Length must be in "
                                       f"[0, {MAX_BODY_BYTES}], got {length}"})
                    return
                # drain the body before any error reply: answering on a
                # keep-alive socket with unread request bytes breaks the
                # client's write and desyncs the connection
                body = self.rfile.read(length)
                if url.path != "/v1/predict":
                    self._reply_json(404, {"error": f"no route {url.path}"})
                    return
                q = parse_qs(url.query)
                output = q.get("output", ["labels"])[0]
                if output not in ("labels", "probs"):
                    self._reply_json(
                        400, {"error": f"output must be labels|probs, "
                                       f"got {output!r}"})
                    return
                preprocess = q.get("preprocess", ["0"])[0] in ("1", "true")
                if length == 0:
                    self._reply_json(400, {"error": "empty request body"})
                    return
                try:
                    payload, latency = server._predict(
                        body, output, preprocess)
                except RequestError as e:
                    self._reply_json(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 - surface, don't die
                    log.exception("predict failed")
                    self._reply_json(500, {"error": f"{type(e).__name__}: "
                                                    f"{e}"})
                    return
                server._requests += 1
                log.info("predict %s: %.3f s", output, latency)
                self._reply(200, payload, "application/x-npy",
                            [("X-Latency-Ms", f"{latency * 1e3:.1f}")])

        return Handler


def serve_bundle(bundle_dir: str, host: str = "127.0.0.1", port: int = 8000,
                 *, device=None, warmup: bool = True,
                 coalesce: Optional[bool] = None,
                 coalesce_wait_s: float = 0.05) -> BundleServer:
    """Load ``bundle_dir`` onto ``device`` (default: the GPU; raises if there
    is none) and return a ready (not yet serving) server."""
    return BundleServer(ServingBundle.load(bundle_dir, device), host, port,
                        warmup=warmup, coalesce=coalesce,
                        coalesce_wait_s=coalesce_wait_s)
