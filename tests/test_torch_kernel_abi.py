"""The kernel wrappers' launch ABI and choice, on the CPU with no card.

For each of K1-K4 and the pose kernel: the parameters the wrapper declares
(``params``, turned into ``argtypes`` by ``pkernel.load_library``) are the
names and C types of its ``extern "C"`` launch function and, for the Newton
kernels, of its occupancy function, parsed from the ``.cu`` source; the
source's one ``__global__`` function is the wrapper's ``symbol``, which
``gpubench/configs/*.json`` ``kernel_symbols`` name for their solver; and
``dispatch`` picks K1-K4 by (solver, ext) and the engine for
``use_soa=False``.
"""

import copy
import ctypes
import glob
import json
import os
import re

import pytest
import torch

from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import dispatch, pkernel

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = {"K1": pkernel.K1, "K2": pkernel.K2, "K3": pkernel.K3, "K4": pkernel.K4,
            "poses": pkernel.POSES}


def c_params(path, fn):
    """``(name, ctype)`` of each parameter of C function ``fn`` in ``path``
    (``MJ_CLOCKS_PARAM``, the stage-clocks build's extra pointer, left out)."""
    with open(path) as f:
        text = f.read()
    found = re.findall(r"\bint\s+" + fn + r"\(([^)]*)\)\s*\{", text)
    assert len(found) == 1, (path, fn)
    out = []
    for param in found[0].replace("MJ_CLOCKS_PARAM", "").split(","):
        *words, name = param.replace("*", " * ").split()
        ctype = (ctypes.c_void_p if "*" in words else ctypes.c_longlong if words == ["long", "long"]
                 else {"int": ctypes.c_int, "float": ctypes.c_float}[words[-1]])
        out.append((name, ctype))
    return out


def source(kernel):
    return os.path.join(ROOT, "mjrl_tpu_torch", "csrc", kernel.file)


@pytest.mark.parametrize("label", list(WRAPPERS))
def test_declared_launch_matches_the_source(label):
    """The wrapper's launch parameters (names, order and ctypes) are its C
    launch function's, and the Newton kernels' occupancy takes one int."""
    kernel = WRAPPERS[label]
    assert kernel.signatures[kernel.launch_fn] == kernel.params
    declared = list(zip(kernel.params, pkernel.argtypes(kernel.params)))
    assert declared == c_params(source(kernel), kernel.launch_fn)
    occupancy = {fn for fn in kernel.signatures if fn.endswith("_occupancy")}
    assert occupancy == ({f"{kernel.name}_occupancy"} if label in ("K2", "K4") else set())
    for fn in occupancy:
        params = kernel.signatures[fn]
        assert list(zip(params, pkernel.argtypes(params))) == c_params(source(kernel), fn)


def test_pose_host_build_takes_the_launch_without_its_stream():
    """``mj_host.cpp``'s ``mj_poses_host``, the pose kernel's CPU build, takes
    ``POSES_PARAMS`` less the stream."""
    params = pkernel.POSES_PARAMS[:-1]
    host = os.path.join(ROOT, "mjrl_tpu_torch", "csrc", "mj_host.cpp")
    assert list(zip(params, pkernel.argtypes(params))) == c_params(host, "mj_poses_host")


@pytest.mark.parametrize("label", list(WRAPPERS))
def test_global_symbol(label):
    """The source's one ``__global__`` function is the wrapper's ``symbol``,
    ``<name>_kernel``."""
    kernel = WRAPPERS[label]
    with open(source(kernel)) as f:
        found = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                           f.read())
    assert found == [kernel.symbol] == [f"{kernel.name}_kernel"]


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "gpubench", "configs",
                                                               "*.json"))))
def test_benchmark_kernel_symbols_are_the_kernels(path):
    """Each benchmark config's ``kernel_symbols`` name, per solver, the
    ``__global__`` function of the kernel its env's frame stepper runs."""
    with open(path) as f:
        config = json.load(f)
    for solver, symbol in config["kernel_symbols"].items():
        env = make(config["job"]["env_name"], device="cpu", constraint_solver=solver)
        assert getattr(pkernel, env._frame_step.path).symbol == symbol


@pytest.fixture(scope="module")
def ant():
    return make("ant", horizon=8, device="cpu").model


@pytest.mark.parametrize("solver, with_link_delta, label", [
    ("penalty", False, "K1"), ("newton", False, "K2"), ("penalty", True, "K3"),
    ("newton", True, "K4")])
def test_dispatch_picks_by_solver_and_ext(ant, solver, with_link_delta, label):
    """``kernel_for`` and the frame stepper's ``path`` give K1-K4 by (solver,
    ext), ext from the link offsets or a stage only K3's and K4's builds
    have (a frictionloss); ``use_soa=False`` gives the engine."""
    model = copy.copy(ant)
    model.constraint_solver = solver
    kernel = pkernel.KERNELS[solver, with_link_delta]
    assert (kernel.label, kernel.solver, kernel.ext) == (label, solver, with_link_delta)
    assert dispatch.kernel_for(model, with_link_delta) is kernel
    assert dispatch.make_frame_stepper(model, 1, with_link_delta).path == label
    assert dispatch.make_frame_stepper(model, 1, with_link_delta, use_soa=False).path == "engine"
    fric = copy.copy(model)
    fric.dof_frictionloss = [0.1] * fric.nv
    assert dispatch.kernel_for(fric) is pkernel.KERNELS[solver, True]
