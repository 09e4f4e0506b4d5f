"""hpx_tpu_torch.core.config against hpx_tpu.core.config.

The layering (defaults, batch environment, ini, environment, command
line, overrides) and the strict-mode contract match the reference's; the
port reads its own file and variables (hpx_tpu_torch.ini,
HPX_TPU_TORCH_*) and its device keys are hpx.cuda.*.
"""

import pytest

from hpx_tpu.core import config as ref
from hpx_tpu.core import errors as ref_errors
from hpx_tpu_torch.core import config as port
from hpx_tpu_torch.core import config_schema
from hpx_tpu_torch.core import errors as port_errors


def test_device_keys_moved_to_cuda():
    keys = config_schema.all_keys()
    assert keys["hpx.cuda.eager_futures"].default == "1"
    assert keys["hpx.cuda.watcher_threads"].default == "2"
    assert not any(k.startswith("hpx.tpu.") for k in keys)
    cfg = port.Configuration(environ={}, ini_files=[], strict=True)
    with pytest.raises(port_errors.UndeclaredConfigKey):
        cfg.get("hpx.tpu.eager_futures")
    with pytest.raises(port_errors.ReservedConfigKey):
        cfg.set("hpx.localities", 2)


def test_layers_match_reference(tmp_path):
    ini = tmp_path / "x.ini"
    ini.write_text("[hpx]\nos_threads = 3\n[app]\nname = demo\n")
    argv = ["prog", "--hpx:threads=5", "--hpx:ini=app.mode=fast", "tail"]
    pairs = [(ref, {"HPX_TPU_PARCEL__PORT": "9"}),
             (port, {"HPX_TPU_TORCH_PARCEL__PORT": "9"})]
    out = []
    for mod, env in pairs:
        cfg = mod.Configuration(argv=argv, environ=env,
                                ini_files=[str(ini)])
        out.append((cfg.os_threads(), cfg.get("app.name"),
                    cfg.get("app.mode"), cfg.get("hpx.parcel.port"),
                    cfg.remaining_argv))
    assert out[0] == out[1] == (5, "demo", "fast", "9", ["prog", "tail"])


def test_env_overlay_reads_cuda_keys():
    cfg = port.Configuration(
        environ={"HPX_TPU_TORCH_CUDA__EAGER_FUTURES": "0",
                 "HPX_TPU_CUDA__WATCHER_THREADS": "7"}, ini_files=[])
    assert cfg.get_bool("hpx.cuda.eager_futures", True) is False
    # the reference's variables are not the port's
    assert cfg.get_int("hpx.cuda.watcher_threads", 0) == 2


@pytest.mark.parametrize("arg", ["--hpx:bogus=1", "--hpx:threads"])
def test_bad_cli_raises_same_error(arg):
    errs = []
    for mod, errors in ((ref, ref_errors), (port, port_errors)):
        with pytest.raises(errors.BadParameter) as e:
            mod.Configuration(argv=[arg], environ={}, ini_files=[])
        errs.append((type(e.value).__name__, int(e.value.code)))
    assert errs[0] == errs[1]


def test_batch_environment_layer():
    env = {"SLURM_PROCID": "1", "SLURM_NTASKS": "4",
           "SLURM_JOB_NODELIST": "nid[001-002]"}
    cfg = port.Configuration(environ=env, ini_files=[])
    assert (cfg.get("hpx.localities"), cfg.get("hpx.locality"),
            cfg.get("hpx.parcel.address")) == ("4", "1", "nid001")
    env["HPX_TPU_TORCH_IGNORE_BATCH_ENV"] = "1"
    assert port.Configuration(environ=env, ini_files=[]).get(
        "hpx.localities") == "1"


@pytest.mark.parametrize("key,good,bad", [
    ("hpx.cache.kv_dtype", "int8", "fp4"),
    ("hpx.serving.paged_kernel", "fused_online", "online"),
])
def test_serving_keys_match_the_reference(key, good, bad):
    """The slice-2 keys carry the reference's defaults, and strict mode
    refuses an enumerated knob's value outside its set, as there."""
    from hpx_tpu.core import config_schema as ref_schema
    for k in ("hpx.serving.prefill_chunk", "hpx.serving.prefill_buckets",
              "hpx.serving.async_dispatch", "hpx.serving.max_async_steps",
              "hpx.serving.admit_retries", "hpx.cache.block_size",
              "hpx.cache.num_blocks", "hpx.cache.prefix_reuse",
              "hpx.cache.radix_budget_blocks", key):
        mine, theirs = config_schema.lookup(k), ref_schema.lookup(k)
        assert (mine.type, mine.default) == (theirs.type, theirs.default), k
    for mod, errs in ((port, port_errors), (ref, ref_errors)):
        cfg = mod.Configuration(environ={}, ini_files=[], strict=True)
        cfg.set(key, good)
        assert cfg.get(key) == good
        with pytest.raises(errs.BadParameter):
            cfg.set(key, bad)
