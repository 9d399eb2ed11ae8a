"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port, ``repro_torch``, passes; ``repro`` does
not), and the plain references import nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

from portbench import loop, spec

ROOT = str(spec.ROOT)

# refuses to import any module whose top-level name is in REFUSED
BLOCK = textwrap.dedent("""
    import sys
    REFUSED = {refused!r}
    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError("refused: " + name)
            return None
    sys.meta_path.insert(0, Refuse())
    sys.path[:0] = [{src!r}, {root!r}]
""")


def _python(code: str, refused) -> dict:
    script = BLOCK.format(refused=set(refused), src=os.path.join(ROOT, "src"),
                          root=ROOT) + textwrap.dedent(code)
    got = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


def test_the_harness_runs_with_jax_and_repro_refused(tmp_path):
    got = _python(f"""
        import json, time
        from portbench import control, faults, loop, run, spec, trace
        from portbench.tests import tiny
        import pathlib
        bench = tiny.bench(pathlib.Path({str(tmp_path)!r}))
        for m in bench["end_to_end"] + bench["per_layer"]:
            spec.module("metrics", m["name"])
        out = loop.run_cell("chol16k-1p", 1, 0.2, True,
                            start_epoch=time.time(), device="cpu",
                            bench=bench)
        tops = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps({{"correct": out["correct"], "tops": tops,
                          "forbidden": out["forbidden"]}}))
    """, loop.FORBIDDEN)
    assert got["correct"] and got["forbidden"] == []
    assert "repro_torch" in got["tops"]
    assert not set(got["tops"]) & set(loop.FORBIDDEN)


def test_the_references_import_nothing_of_the_program():
    got = _python("""
        import json, torch
        from portbench import spec
        a = torch.randn(32, 32, dtype=torch.float64)
        for app in ("cholesky", "gemm2d"):
            spec.module("reference", app)
        tops = sorted({m.split(".")[0] for m in sys.modules})
        print(json.dumps({"tops": tops}))
    """, loop.FORBIDDEN + ("repro_torch",))
    assert "portbench" in got["tops"] and "torch" in got["tops"]
    assert not {"repro_torch", "repro", "jax"} & set(got["tops"])


def test_the_forbidden_names_are_compared_whole():
    assert loop.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(loop.FORBIDDEN))
    assert "repro_torch" not in loop.FORBIDDEN
