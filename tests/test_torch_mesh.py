"""The port's meshes (``repro_torch.launch.mesh``) and its compressed
all-reduce (``repro_torch.optim.compressed_allreduce_demo``) on the CPU.

* ``make_production_mesh`` at 256 ranks (data 16, model 16) and 512
  (pod 2, data 16, model 16) under PyTorch's fake process group, in a
  subprocess: axis names, sizes, ``devices_per_pod``, the dim groups'
  sizes, and a family's specs through ``AxisRules`` on the ``DeviceMesh``
  equal to the same rules over the name -> size mapping;
* importing the module initialises no process group;
* ``compressed_allreduce_demo`` on (pod 2, data 4) gloo ranks: every
  rank's output equals the reference's on 8 fake XLA devices within 1e-6
  and the analytic mean ``x * 1.035`` within 2e-2
  (``tests/test_optim.py:65-76``), and the payload all-gathered over
  ``pod`` is int8.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch.distributed as dist

import _torch_ranks as ranks
from conftest import run_subprocess
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch.mesh import devices_per_pod

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("multi_pod,world", [(False, 256), (True, 512)])
def test_production_mesh_under_fake_process_group(multi_pod, world):
    code = textwrap.dedent(f"""
    import json, sys
    sys.path.insert(0, {SRC!r})
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (AxisRules, DEFAULT_RULES,
                                                  mesh_shape)
    from repro_torch.launch.mesh import devices_per_pod, make_production_mesh
    from repro_torch.models.convert import param_specs
    from repro_torch.tree import tree_leaves
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size={world})
    try:
        mesh = make_production_mesh(multi_pod={multi_pod},
                                    device_type="cpu")
        shape = mesh_shape(mesh)
        specs = tree_leaves(param_specs(get_config("qwen2-0.5b")))
        dims = [(151936, 896), (896, 896), (896, 128), (896, 4864),
                (4864, 896)]
        on_mesh = AxisRules(mesh, dict(DEFAULT_RULES))
        on_map = AxisRules(shape, dict(DEFAULT_RULES))
        same = all(on_mesh.spec(n, d) == on_map.spec(n, d)
                   for n in specs if len(n) == 2 for d in dims)
        print(json.dumps(dict(
            names=list(mesh.mesh_dim_names), shape=list(mesh.shape),
            size=mesh.size(), per_pod=devices_per_pod(mesh),
            groups={{a: dist.get_world_size(mesh.get_group(a))
                    for a in mesh.mesh_dim_names}},
            same=same, fallbacks=on_mesh.fallbacks == on_map.fallbacks)))
    finally:
        dist.destroy_process_group()
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    names = ["pod", "data", "model"] if multi_pod else ["data", "model"]
    shape = [2, 16, 16] if multi_pod else [16, 16]
    assert got["names"] == names and got["shape"] == shape
    assert got["size"] == world
    assert got["per_pod"] == (256 if multi_pod else None)
    assert got["groups"] == dict(zip(names, shape))
    assert got["same"] and got["fallbacks"]


def test_devices_per_pod_on_a_mapping_and_import_is_inert():
    assert devices_per_pod({"data": 16, "model": 16}) is None
    assert devices_per_pod({"pod": 2, "data": 16, "model": 16}) == 256
    assert devices_per_pod({"pod": 4, "data": 2}) == 2
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def reference_demo(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    run_subprocess(f"""
    import numpy as np, jax, jax.numpy as jnp
    from repro.optim import compressed_allreduce_demo
    mesh = jax.make_mesh((2, 4), ("pod", "data"),
                         axis_types=(jax.sharding.AxisType.Auto,)*2)
    x = jnp.arange(64, dtype=jnp.float32) / 64.0
    with mesh:
        out = compressed_allreduce_demo(x, mesh)
    np.save({str(d / "out.npy")!r}, np.asarray(out))
    print("OK")
    """, devices=8)
    return np.load(d / "out.npy")


def test_compressed_allreduce_demo_matches_reference(reference_demo):
    x = np.arange(64, dtype=np.float32) / 64.0
    outs = run_ranks(ranks.demo_body, 8, x, device="cpu", timeout=60.0)
    for rank, (out, gathered) in enumerate(outs):
        np.testing.assert_allclose(out, reference_demo, rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {rank}")
        # device r contributes x*(1+0.01r); the mean over ranks 0..7
        np.testing.assert_allclose(out, x * 1.035, atol=2e-2)
        # the payload and its scale, each gathered over the 2 pods
        assert gathered == [("torch.int8", 2), ("torch.float32", 2)]
