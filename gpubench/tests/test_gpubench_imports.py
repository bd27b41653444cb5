"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the system under test."""

import subprocess
import sys

from conftest import REPO

CHECK = """
import sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
{body}
top = {{m.split('.')[0] for m in sys.modules}}
bad = sorted(top & {{'jax', 'jaxlib', 'flax', 'stabletriton_tpu'}})
print('BAD', bad, 'PORT', 'stabletriton_tpu_torch' in top)
"""


def _top_modules(body):
    code = CHECK.format(repo=str(REPO), tests=str(REPO / "gpubench/tests"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_the_reference_loads_nothing_of_the_system():
    assert _top_modules("import gpubench.reference.sd, gpubench.work.unet2d, "
                        "gpubench.weights, gpubench.traffic, gpubench.tokenizer") \
        == "BAD [] PORT False"


def test_a_whole_run_loads_no_jax(tmp_path):
    body = f"""
import pathlib
from conftest import make_root
from gpubench import harness
root = make_root(pathlib.Path({str(tmp_path)!r}))
harness.run_cell('tiny.tinymix', 3, 0.5, True, device='cpu', root=root)
"""
    assert _top_modules(body) == "BAD [] PORT True"


def test_run_py_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "sd-1.5.interactive",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=REPO,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
