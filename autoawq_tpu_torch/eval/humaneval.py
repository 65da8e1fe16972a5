"""HumanEval: generation, sandboxed execution and unbiased pass@k.

The port's own copy of ``autoawq_tpu/eval/humaneval.py`` (pure Python and
numpy; the port imports nothing of the JAX package), itself a
re-implementation of the reference harness
(awq/evaluation/humaneval_utils.py): each completion runs in a forked
subprocess under a reliability guard that disables destructive os-level
APIs, with a hard wall-clock limit; pass@k uses the unbiased estimator
(humaneval_utils.py:268).

The problems (openai_humaneval) are passed in as a list of dicts
({"task_id", "prompt", "test", "entry_point"}), so the harness works
offline; ``load_humaneval()`` fetches them through ``datasets``, imported
when it is called.
"""

from __future__ import annotations

import itertools
import json
import multiprocessing
import os
import tempfile
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

_GUARD = r"""
import builtins, faulthandler, os, platform, shutil, subprocess, sys

def _disabled(*a, **k):
    raise RuntimeError("disabled by sandbox")

faulthandler.disable()
builtins.exit = _disabled
builtins.quit = _disabled
os.environ["OMP_NUM_THREADS"] = "1"
for name in ("kill", "system", "putenv", "remove", "removedirs", "rmdir",
             "unlink", "fork", "forkpty", "killpg", "rename", "renames",
             "truncate", "replace", "chmod", "chown", "chdir"):
    if hasattr(os, name):
        setattr(os, name, _disabled)
for name in ("rmtree", "move", "chown"):
    if hasattr(shutil, name):
        setattr(shutil, name, _disabled)
subprocess.Popen = _disabled
sys.modules["ipdb"] = None
sys.modules["joblib"] = None
sys.modules["resource"] = None
sys.modules["psutil"] = None
"""


def _run_one(code: str, timeout: float, result_queue):
    """Subprocess target: exec the candidate program under the guard."""
    import io
    import contextlib
    import signal

    def handler(signum, frame):
        raise TimeoutError("time limit")

    signal.signal(signal.SIGALRM, handler)
    signal.setitimer(signal.ITIMER_REAL, timeout)
    try:
        exec_globals: Dict[str, Any] = {}
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            exec(_GUARD + "\n" + code, exec_globals)
        result_queue.put("passed")
    except TimeoutError:
        result_queue.put("timed out")
    except BaseException as e:  # noqa: BLE001 — report any failure mode
        result_queue.put(f"failed: {type(e).__name__}: {e}")
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)


def check_correctness(problem: Dict[str, str], completion: str,
                      timeout: float = 10.0) -> Dict[str, Any]:
    """Run one completion against its tests in an isolated subprocess
    (reference: humaneval_utils.py:112-181)."""
    program = (
        problem["prompt"] + completion + "\n"
        + problem["test"] + "\n"
        + f"check({problem['entry_point']})\n"
    )
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=_run_one, args=(program, timeout, q))
    p.start()
    p.join(timeout + 5)
    if p.is_alive():
        p.terminate()
        p.join()
        result = "timed out"
    else:
        result = q.get() if not q.empty() else "failed: no result"
    return {
        "task_id": problem["task_id"],
        "passed": result == "passed",
        "result": result,
    }


def estimate_pass_at_k(num_samples, num_correct, k: int) -> np.ndarray:
    """Unbiased pass@k (reference: humaneval_utils.py:268)."""

    def estimator(n: int, c: int, k: int) -> float:
        if n - c < k:
            return 1.0
        return 1.0 - float(np.prod(1.0 - k / np.arange(n - c + 1, n + 1)))

    if isinstance(num_samples, int):
        num_samples_it: Iterable[int] = itertools.repeat(num_samples,
                                                         len(num_correct))
    else:
        num_samples_it = iter(num_samples)
    return np.array(
        [estimator(int(n), int(c), k)
         for n, c in zip(num_samples_it, num_correct)]
    )


def stop_at_stop_token(text: str) -> str:
    """Trim a completion at the canonical HumanEval stop sequences."""
    for stop in ("\nclass ", "\ndef ", "\n#", "\nif ", "\nprint(", "\n```"):
        idx = text.find(stop)
        if idx != -1:
            text = text[:idx]
    return text


def eval_humaneval(
    generate_fn: Callable[[str], str],
    problems: List[Dict[str, str]],
    n_samples_per_task: int = 1,
    timeout: float = 10.0,
    ks=(1,),
    out_path: Optional[str] = None,
) -> Dict[str, float]:
    """Full harness: generate -> sandbox-execute -> pass@k.

    ``generate_fn(prompt) -> completion`` abstracts the model (greedy for
    pass@1, sampled for larger n).
    """
    results: List[Dict[str, Any]] = []
    for problem in problems:
        for _ in range(n_samples_per_task):
            completion = stop_at_stop_token(generate_fn(problem["prompt"]))
            results.append(check_correctness(problem, completion, timeout))
    per_task: Dict[str, List[bool]] = {}
    for r in results:
        per_task.setdefault(r["task_id"], []).append(r["passed"])
    totals = [len(v) for v in per_task.values()]
    corrects = [sum(v) for v in per_task.values()]
    metrics = {
        f"pass@{k}": float(estimate_pass_at_k(totals, corrects, k).mean())
        for k in ks
        if all(t >= k for t in totals)
    }
    if out_path:
        with open(out_path, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return metrics


def load_humaneval() -> List[Dict[str, str]]:
    """Fetch openai_humaneval via ``datasets`` (needs network)."""
    from datasets import load_dataset

    ds = load_dataset("openai_humaneval", split="test")
    return [dict(r) for r in ds]
