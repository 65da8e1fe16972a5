"""The port's HTTP front-end (``serve/server.py``) over its engines on the
CPU, through loopback: completions, SSE streaming, stop sequences,
cancellation, bursts and a malformed request. Every greedy stream that
comes back over HTTP equals the same engine's own ``run()`` on the same
request, token for token."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.serve.batching import BatchingEngine
from autoawq_tpu_torch.serve.paged import PagedBatchingEngine
from autoawq_tpu_torch.serve.server import start_server
from autoawq_tpu_torch.utils.synth import random_quantized_params

CFG = ModelConfig(model_type="llama", vocab_size=96, hidden_size=128,
                  intermediate_size=256, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=32)


@pytest.fixture(scope="module")
def params():
    return random_quantized_params(CFG, seed=4, group_size=64, device="cpu")


def _engine(params, kind, pages_per_seq=8):
    if kind == "paged":
        return PagedBatchingEngine(CFG, params, max_batch=2, page_size=8,
                                   total_pages=48, pages_per_seq=pages_per_seq,
                                   dtype=torch.float32, device="cpu")
    return BatchingEngine(CFG, params, max_batch=2, max_seq_len=64,
                          dtype=torch.float32, device="cpu")


def _ref(params, kind, prompt, n, **kw):
    eng = _engine(params, kind)
    eng.add_request("r", np.asarray(prompt), n, **kw)
    return eng.run()["r"]


def _post(port, obj, path="/v1/completions"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _stream(port, obj, first=None):
    """SSE token ids of one streamed completion; ``first`` (an Event) is set
    at the first token."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(dict(obj, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    toks = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for line in r:
            line = line.decode().strip()
            if line == "data: [DONE]":
                break
            if line.startswith("data: "):
                toks += json.loads(line[6:])["choices"][0].get(
                    "token_ids", [])
                if first is not None:
                    first.set()
    return toks


class _Server:
    def __init__(self, engine, burst=1):
        self.es, self.httpd = start_server(engine, tokenizer=None,
                                           burst=burst)
        self.port = self.httpd.server_address[1]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.es.shutdown()


@pytest.mark.parametrize("kind,burst", [("slots", 1), ("paged", 1),
                                        ("paged", 4)])
def test_completions_and_sse_equal_engine_run(params, kind, burst):
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(0, 96, (7,))]
    ref = _ref(params, kind, prompt, 9)
    with _Server(_engine(params, kind), burst) as s:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{s.port}/health", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        status, out = _post(s.port, {"prompt": prompt, "max_tokens": 9})
        assert status == 200 and out["choices"][0]["token_ids"] == ref
        assert out["usage"]["completion_tokens"] == 9
        assert _stream(s.port, {"prompt": prompt, "max_tokens": 9}) == ref
        with urllib.request.urlopen(
                f"http://127.0.0.1:{s.port}/metrics", timeout=30) as r:
            assert json.loads(r.read())["finished"] == 0  # drained


def test_stop_sequence_over_http(params):
    rng = np.random.default_rng(1)
    prompt = [int(t) for t in rng.integers(0, 96, (6,))]
    free = _ref(params, "paged", prompt, 10)
    stop = free[4:6]
    ref = _ref(params, "paged", prompt, 10, stop=[stop])
    assert len(ref) < len(free)
    with _Server(_engine(params, "paged")) as s:
        _, out = _post(s.port, {"prompt": prompt, "max_tokens": 10,
                                "stop": [stop]})
        assert out["choices"][0]["token_ids"] == ref
        assert _stream(s.port, {"prompt": prompt, "max_tokens": 10,
                                "stop": [stop]}) == ref


def test_cancel_and_bad_requests(params):
    """A stream cancelled after its first token ends early with [DONE]; a
    malformed body and an oversized prompt get 400, and the engine thread
    keeps serving."""
    rng = np.random.default_rng(2)
    prompt = [int(t) for t in rng.integers(0, 96, (5,))]
    with _Server(_engine(params, "paged", pages_per_seq=32)) as s:
        got, first = {}, threading.Event()

        def client():
            got["toks"] = _stream(s.port, {"prompt": prompt,
                                           "max_tokens": 250,
                                           "request_id": "c1"}, first)
        t = threading.Thread(target=client)
        t.start()
        assert first.wait(timeout=60)
        _, ack = _post(s.port, {"request_id": "c1"}, path="/v1/cancel")
        assert ack["status"] == "cancelling"
        t.join(timeout=60)
        assert not t.is_alive() and len(got["toks"]) < 250
        for body in ({"max_tokens": 4}, {"prompt": list(range(300)),
                                         "max_tokens": 4}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(s.port, body)
            assert err.value.code == 400
        status, out = _post(s.port, {"prompt": prompt, "max_tokens": 3})
        assert status == 200
        assert out["choices"][0]["token_ids"] == _ref(params, "paged",
                                                      prompt, 3)
