"""Minimal OpenAI-compatible HTTP front-end over the batching engines.

Counterpart of ``autoawq_tpu/serve/server.py``, which is engine-agnostic;
this copy drives the port's ``serve/batching.BatchingEngine`` and
``serve/paged.PagedBatchingEngine``. Stdlib only (http.server +
threading): one engine thread owns the engine (engines are not
thread-safe) and drives ``step()`` (or ``step_burst(burst)``) whenever work
exists; HTTP handlers enqueue requests and wait on per-request events.
Endpoints:

* ``POST /v1/completions`` — {"prompt": str|[ids], "max_tokens": N,
  "temperature": t, "top_k": k, "top_p": p, "stream": bool, "stop",
  "n", "repetition_penalty", "request_id"}. Non-stream returns an
  OpenAI-shaped completion object; ``stream=true`` sends SSE chunks, one
  per generated token, then ``data: [DONE]``.
* ``POST /v1/chat/completions`` — {"messages": [{"role", "content"}, ...],
  same sampling fields}, rendered through the tokenizer's chat template
  when it has one, else a generic ``<|role|>`` template.
* ``POST /v1/cancel`` — {"request_id"}: aborts that client's requests.
* ``GET /v1/models``, ``GET /health``, ``GET /metrics`` (engine stats).

It listens where it is told (``start_server`` defaults to 127.0.0.1 and a
free port).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _HTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a real accept backlog: socketserver's
    default ``request_queue_size`` is 5, so a burst of >5 simultaneous
    connects (16 concurrent SSE clients in scripts/bench_serve.py) gets
    kernel-RST'd before accept — observed as whole client streams lost."""

    daemon_threads = True
    request_queue_size = 128
from queue import Empty, Queue
from typing import Any, Dict, List, Optional

import numpy as np


class _Pending:
    def __init__(self, prompt_ids, max_tokens, temperature, top_k, top_p,
                 stream, client_id=None, chat=False,
                 repetition_penalty=1.0, stop=None):
        self.chat = chat  # shape the response as chat.completion
        self.repetition_penalty = repetition_penalty
        self.stop = stop  # token-id sequences; engine trims the match
        self.final_len: Optional[int] = None  # trimmed output length
        self.prompt_ids = prompt_ids
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.stream = stream
        self.client_id = client_id
        self.tokens: "Queue[Optional[int]]" = Queue()  # None = finished
        self.sent = 0  # prefix of req.output already pushed
        self.error: Optional[str] = None
        self.logprobs: Optional[list] = None  # filled at finish when the
        # engine was built with return_logprobs=True
        self.top_logprobs: Optional[list] = None  # top_logprobs=N dicts
        self.done = threading.Event()


class EngineServer:
    """Engine thread + HTTP server. ``tokenizer`` needs encode(str)->ids
    and decode(ids)->str; pass None to speak raw token-id lists."""

    def __init__(self, engine, tokenizer=None, model_name: str = "model",
                 max_queue: int = 256, burst: int = 1):
        self.engine = engine
        self.tok = tokenizer
        self.model_name = model_name
        self.max_queue = max_queue
        # burst > 1 = multi-step scheduling: the engine decodes that many
        # tokens per device dispatch (engine.step_burst) — 4.7-5.6x pool
        # throughput, at the cost of flushing streams every `burst`
        # tokens instead of every token. Engines without step_burst (or
        # the speculative pool, which has its own rounds) fall back to
        # per-token steps inside step_burst itself.
        self.burst = max(1, int(burst))
        self._pending: "Queue[_Pending]" = Queue()
        self._cancel_q: "Queue[Any]" = Queue()
        self._live: Dict[Any, _Pending] = {}
        self._by_client: Dict[Any, list] = {}  # client_id -> engine rids
        # (a list: "n" > 1 fans one client request into n engine requests)
        self._next_id = 0
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------ engine thread
    def _loop(self):
        while not self._stop:
            # cancellations route through THIS thread (the engines are not
            # thread-safe; a cancel racing step() could kill live slots)
            while True:
                try:
                    cid = self._cancel_q.get_nowait()
                except Empty:
                    break
                for rid in self._by_client.pop(cid, []):
                    self.engine.cancel(rid)
                    live = self._live.pop(rid, None)
                    if live is not None:
                        live.error = "cancelled"
                        live.tokens.put(None)
                        live.done.set()
            admitted = False
            while True:
                try:
                    p = self._pending.get_nowait()
                except Empty:
                    break
                with self._lock:
                    rid = self._next_id
                    self._next_id += 1
                try:
                    self.engine.add_request(
                        rid, np.asarray(p.prompt_ids), p.max_tokens,
                        temperature=p.temperature, top_k=p.top_k,
                        top_p=p.top_p,
                        repetition_penalty=p.repetition_penalty,
                        stop=p.stop)
                except (ValueError, NotImplementedError) as e:
                    # reject THIS request; the engine thread must survive
                    # (an unhandled raise here bricks every other client)
                    p.error = str(e)
                    p.tokens.put(None)
                    p.done.set()
                    continue
                self._live[rid] = p
                if p.client_id is not None:
                    self._by_client.setdefault(p.client_id, []).append(rid)
                admitted = True
            if not (admitted or self.engine.has_work):
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                if self.burst > 1 and hasattr(self.engine, "step_burst"):
                    self.engine.step_burst(self.burst)
                else:
                    self.engine.step()
            except Exception as e:  # fail loudly but keep serving
                for live in self._live.values():
                    live.error = f"engine step failed: {e}"
                    live.tokens.put(None)
                    live.done.set()
                self._live.clear()
                continue
            # route tokens by OUTPUT GROWTH, not step()'s return — the
            # first token of every request is appended at admission
            # (prefill logits) and never passes through step()
            for req in self.engine.slots:
                if req is not None:
                    self._flush(req)
            for req in list(self.engine.finished):
                self._flush(req)
                live = self._live.pop(req.id, None)
                if live is not None:
                    if live.client_id is not None:
                        rids = self._by_client.get(live.client_id, [])
                        if req.id in rids:
                            rids.remove(req.id)
                        if not rids:
                            self._by_client.pop(live.client_id, None)
                    live.final_len = len(req.output)
                    if req.logprobs:
                        live.logprobs = list(req.logprobs)[: live.final_len]
                    if req.top_logprobs:
                        live.top_logprobs = \
                            list(req.top_logprobs)[: live.final_len]
                    live.tokens.put(None)
                    live.done.set()
            self.engine.finished.clear()

    def _flush(self, req):
        live = self._live.get(req.id)
        if live is None:
            return
        while live.sent < len(req.output):
            live.tokens.put(int(req.output[live.sent]))
            live.sent += 1

    def submit(self, p: _Pending):
        self._pending.put(p)
        self._wake.set()

    def cancel(self, client_id) -> None:
        """Thread-safe: enqueue a cancellation; the engine thread applies
        it before its next admission round."""
        self._cancel_q.put(client_id)
        self._wake.set()

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)

    def _logprobs_payload(self, p: "_Pending") -> Dict[str, Any]:
        """Response logprobs block. top_logprobs entries are LISTS of
        {token, token_id, logprob} (distinct ids that decode to the same
        string — byte-fallback pieces — would collide as dict keys)."""
        out: Dict[str, Any] = {"token_logprobs": p.logprobs}
        if p.top_logprobs is not None:
            out["top_logprobs"] = [
                sorted(({"token": (self.tok.decode([t]) if self.tok
                                   is not None else None),
                         "token_id": t, "logprob": v}
                        for t, v in d.items()),
                       key=lambda e: -e["logprob"])
                for d in p.top_logprobs]
        return out

    def _chat_ids(self, messages) -> List[int]:
        """Render a chat message list to prompt ids: the tokenizer's own
        chat template when it carries one (HF tokenizers), else a generic
        <|role|> framing."""
        if self.tok is None:
            raise ValueError("chat completions need a tokenizer")
        msgs = [{"role": str(m["role"]), "content": str(m["content"])}
                for m in messages]
        if not msgs:
            raise ValueError("messages must be non-empty")
        if getattr(self.tok, "chat_template", None) is not None \
                and hasattr(self.tok, "apply_chat_template"):
            return [int(t) for t in self.tok.apply_chat_template(
                msgs, add_generation_prompt=True, tokenize=True)]
        text = "".join(f"<|{m['role']}|>\n{m['content']}\n" for m in msgs)
        return self.tok.encode(text + "<|assistant|>\n")

    # --------------------------------------------------------------- http
    def make_handler(server):  # noqa: N805 — closure over the EngineServer
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj: Dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    return self._json(200, {"status": "ok"})
                if self.path == "/v1/models":
                    return self._json(200, {"object": "list", "data": [
                        {"id": server.model_name, "object": "model"}]})
                if self.path == "/metrics":
                    st = (server.engine.stats()
                          if hasattr(server.engine, "stats") else {})
                    st["pending_http"] = server._pending.qsize()
                    return self._json(200, st)
                return self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/v1/cancel":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                        server.cancel(body["request_id"])
                    except (KeyError, json.JSONDecodeError) as e:
                        return self._json(400, {"error": str(e)})
                    return self._json(200, {"status": "cancelling"})
                chat = self.path == "/v1/chat/completions"
                if self.path != "/v1/completions" and not chat:
                    return self._json(404, {"error": "not found"})
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if chat:
                        ids = server._chat_ids(req["messages"])
                    else:
                        prompt = req["prompt"]
                        if isinstance(prompt, str):
                            if server.tok is None:
                                raise ValueError(
                                    "no tokenizer: send token ids")
                            ids = server.tok.encode(prompt)
                        else:
                            ids = [int(t) for t in prompt]
                    # cast EVERY body field here: uncast values would
                    # raise inside the engine thread and take down every
                    # live request
                    max_tokens = int(req.get("max_tokens") or 16)
                    temperature = float(req.get("temperature") or 0.0)
                    top_k = (None if req.get("top_k") is None
                             else int(req["top_k"]))
                    top_p = (None if req.get("top_p") is None
                             else float(req["top_p"]))
                    rep_pen = float(req.get("repetition_penalty") or 1.0)
                    stop = req.get("stop")
                    if stop is not None:
                        if isinstance(stop, str):
                            stop = [stop]
                        seqs = []
                        for s in stop:
                            if isinstance(s, str):
                                if server.tok is None:
                                    raise ValueError(
                                        "string stop needs a tokenizer")
                                # HF tokenizers prepend BOS by default —
                                # a stop starting with BOS never matches
                                # generated output
                                try:
                                    enc = server.tok.encode(
                                        s, add_special_tokens=False)
                                except TypeError:
                                    enc = server.tok.encode(s)
                                seqs.append([int(t) for t in enc])
                            else:  # a token-id sequence
                                seqs.append([int(t) for t in s])
                        stop = seqs
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    return self._json(400, {"error": str(e)})
                try:
                    n = int(req.get("n") or 1)
                    stream = bool(req.get("stream", False))
                    if n < 1:
                        raise ValueError("n must be >= 1")
                    if n > 1 and stream:
                        raise ValueError("n > 1 does not stream")
                    if n > 1 and not (temperature and temperature > 0.0):
                        raise ValueError("n > 1 needs temperature > 0 "
                                         "(greedy choices are identical)")
                except (ValueError, TypeError) as e:
                    return self._json(400, {"error": str(e)})
                with server._lock:  # atomic check+put (burst-safe cap)
                    if (server._pending.qsize() + n - 1
                            + len(server.engine.queue)
                            >= server.max_queue):
                        return self._json(429, {"error": "queue full"})
                    pends = [
                        _Pending(ids, max_tokens, temperature, top_k,
                                 top_p, stream,
                                 client_id=req.get("request_id"),
                                 chat=chat, repetition_penalty=rep_pen,
                                 stop=stop)
                        for i in range(n)]
                    for p in pends:
                        server._pending.put(p)
                server._wake.set()
                if pends[0].stream:
                    return self._stream(pends[0])
                choices = []
                for i, p in enumerate(pends):
                    p.done.wait()
                    if p.error is not None:
                        return self._json(400, {"error": p.error})
                    out: List[int] = []
                    while True:
                        t = p.tokens.get()
                        if t is None:
                            break
                        out.append(t)
                    if p.final_len is not None:
                        # stop-sequence tokens pushed before the engine
                        # trimmed them do not belong in the response
                        out = out[: p.final_len]
                    text = (server.tok.decode(out)
                            if server.tok is not None else None)
                    if p.chat:
                        choice = {"index": i,
                                  "message": {"role": "assistant",
                                              "content": text},
                                  "token_ids": out,
                                  "finish_reason": "stop"}
                    else:
                        choice = {"index": i, "text": text,
                                  "token_ids": out,
                                  "finish_reason": "stop"}
                    if p.logprobs is not None:
                        choice["logprobs"] = server._logprobs_payload(p)
                    choices.append(choice)
                completion = sum(len(c["token_ids"]) for c in choices)
                self._json(200, {
                    "id": "chatcmpl-0" if chat else "cmpl-0",
                    "object": ("chat.completion" if chat
                               else "text_completion"),
                    "created": int(time.time()), "model": server.model_name,
                    "choices": choices,
                    "usage": {"prompt_tokens": len(ids),
                              "completion_tokens": completion,
                              "total_tokens": len(ids) + completion},
                })

            def _emit_chunk(self, p: _Pending, t: int):
                piece = (server.tok.decode([t])
                         if server.tok is not None else None)
                if p.chat:
                    chunk = {"object": "chat.completion.chunk",
                             "choices": [{"index": 0,
                                          "delta": {"content": piece},
                                          "token_ids": [t]}]}
                else:
                    chunk = {"object": "text_completion.chunk",
                             "choices": [{"index": 0, "text": piece,
                                          "token_ids": [t]}]}
                self.wfile.write(
                    b"data: " + json.dumps(chunk).encode() + b"\n\n")
                self.wfile.flush()

            def _stream(self, p: _Pending):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                # stop sequences: hold back the longest possible match so
                # stop tokens NEVER reach a streaming client (the match
                # is only known at retirement, when the engine trims it)
                hold = max((len(s) for s in (p.stop or [])), default=0)
                pending: List[int] = []
                sent = 0
                while True:
                    t = p.tokens.get()
                    if t is None:
                        # flush any held tokens the trim did not consume
                        if p.final_len is not None:
                            pending = pending[: max(p.final_len - sent, 0)]
                        for h in pending:
                            self._emit_chunk(p, h)
                        if p.logprobs is not None:
                            # final summary chunk: streaming clients get
                            # the same logprobs non-stream responses carry
                            fin = {"object": ("chat.completion.chunk"
                                              if p.chat
                                              else "text_completion.chunk"),
                                   "choices": [{
                                       "index": 0,
                                       "finish_reason": "stop",
                                       "logprobs":
                                           server._logprobs_payload(p)}]}
                            self.wfile.write(
                                b"data: " + json.dumps(fin).encode()
                                + b"\n\n")
                        self.wfile.write(b"data: [DONE]\n\n")
                        self.wfile.flush()
                        return
                    pending.append(t)
                    while len(pending) > hold:
                        self._emit_chunk(p, pending.pop(0))
                        sent += 1

        return Handler


def serve_http(engine, tokenizer=None, host: str = "127.0.0.1",
               port: int = 8000, model_name: str = "model",
               burst: int = 1):
    """Blocking: serve the engine over HTTP. Returns (never) — use
    start_server for a background instance. ``burst`` > 1 enables
    multi-step scheduling (tokens flush every `burst` steps)."""
    es, httpd = start_server(engine, tokenizer, host, port, model_name,
                             burst=burst)
    try:
        httpd.serve_forever()
    finally:
        es.shutdown()


def start_server(engine, tokenizer=None, host: str = "127.0.0.1",
                 port: int = 0, model_name: str = "model",
                 max_queue: int = 256, burst: int = 1):
    """Non-blocking: returns (EngineServer, ThreadingHTTPServer) with the
    HTTP loop on a daemon thread. port=0 picks a free port
    (httpd.server_address[1])."""
    es = EngineServer(engine, tokenizer, model_name, max_queue,
                      burst=burst)
    httpd = _HTTPServer((host, port), es.make_handler())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return es, httpd
