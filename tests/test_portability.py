"""What a copied checkout needs to run on another machine.

* the device path imports neither pandas nor matplotlib (the colormap
  table is committed);
* the native tokenizer library is keyed by the host CPU, so a checkout
  copied to another machine builds its own;
* trace reading needs only JAX, and a trace without a device plane is an
  error, never a host-clock number under a device name.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tests.conftest import REPO_ROOT


def test_committed_viridis_table_equals_matplotlib():
    import matplotlib

    from slam_process_tpu.ops.raster import colormap_lut

    ref = matplotlib.colormaps["viridis"](np.linspace(0.0, 1.0, 256))
    got = colormap_lut("viridis")
    assert got.shape == (256, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref.astype(np.float32))


def test_other_colormaps_still_come_from_matplotlib():
    import matplotlib

    from slam_process_tpu.ops.raster import colormap_lut

    got = colormap_lut("magma", 16)
    ref = matplotlib.colormaps["magma"](np.linspace(0.0, 1.0, 16))
    np.testing.assert_array_equal(got, ref.astype(np.float32))


def test_device_path_imports_neither_pandas_nor_matplotlib(tmp_path):
    """Bytes -> raster, paths, tracks and events with the device engines,
    in a fresh process; then pandas and matplotlib must not be loaded."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO_ROOT)!r})
        import jax
        jax.config.update("jax_platforms", "cpu")
        from slam_process_tpu.io import synth
        from slam_process_tpu.io.angles import write_angle_map
        from slam_process_tpu.parallel.streaming_device import (
            DeviceStreamingSession, make_paths_spec)
        from slam_process_tpu.pipeline.device import run_session_on_device
        from slam_process_tpu.pipeline.session import Session

        cap = synth.capture(0, 3000, 2)
        path = synth.write_capture({str(tmp_path)!r}, cap)
        mapping = write_angle_map({str(tmp_path / "map.xlsx")!r})
        jax.block_until_ready(run_session_on_device(cap.wire).rgba)
        s = Session.from_log(path, engine="device")
        s.sweep_paths(mapping)
        d = DeviceStreamingSession(chunk_bytes=1 << 14,
                                   collect_paths=make_paths_spec(mapping))
        d.feed(cap.wire)
        d.finalize()
        d.path_tracks()
        bad = [m for m in ("pandas", "matplotlib") if m in sys.modules]
        print("LOADED", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_hexscan_library_is_keyed_by_host_cpu(monkeypatch):
    from slam_process_tpu.runtime import hexscan

    key = hexscan.host_cpu_key()
    assert hexscan.lib_path().name == f"libhexscan-{key}.so"
    assert key == hexscan.host_cpu_key()           # stable on one host

    import builtins
    import io

    real_open = builtins.open

    def fake_open(path, *a, **k):
        if str(path) == "/proc/cpuinfo":
            return io.StringIO("flags\t\t: fpu sse2 avx2\n")
        return real_open(path, *a, **k)

    monkeypatch.setattr(builtins, "open", fake_open)
    assert hexscan.host_cpu_key() != key            # another CPU, another lib


def test_hexscan_builds_from_committed_source():
    from slam_process_tpu.runtime import hexscan

    if not hexscan.available():
        pytest.skip("no C compiler on this host")
    assert hexscan.lib_path().exists()
    assert hexscan.lib_path().parent == REPO_ROOT / "build"
    np.testing.assert_array_equal(hexscan.tokenize(b"\xc2\xab 0A ff 7G 10"),
                                  np.array([0x0A, 0xFF, 0x10], np.uint8))


def test_cpu_trace_has_no_device_plane(tmp_path):
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.utils.device_timing import measure_device_time

    f = jax.jit(lambda x: x * 2)
    f(jnp.ones(4)).block_until_ready()
    with pytest.raises(RuntimeError, match="no device plane"):
        measure_device_time(lambda i: f(jnp.ones(4)), n=1,
                            trace_dir=tmp_path)


_TRACE = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "XLA Modules"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000 }
    events { metadata_id: 2 offset_ps: 3000000 duration_ps: 500000 }
    events { metadata_id: 1 offset_ps: 5000000 duration_ps: 3000000 }
  }
  lines {
    id: 2
    name: "XLA Ops"
    timestamp_ns: 1000
    events { metadata_id: 3 offset_ps: 0 duration_ps: 1500000 }
    events { metadata_id: 3 offset_ps: 5000000 duration_ps: 1000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "jit_step(123)" } }
  event_metadata { key: 2 value { id: 2 name: "jit_other(9)" } }
  event_metadata { key: 3 value { id: 3 name: "fusion.7" } }
}
planes { id: 2 name: "/host:CPU" }
"""


def test_trace_reduction_on_a_recorded_device_plane(tmp_path):
    from jax.profiler import ProfileData

    from slam_process_tpu.utils.device_timing import (
        module_device_times,
        op_device_times,
    )

    (tmp_path / "t.xplane.pb").write_bytes(
        ProfileData.text_proto_to_serialized_xspace(_TRACE))
    mods = module_device_times(tmp_path)
    assert mods == {"jit_step": [2e-6, 3e-6], "jit_other": [5e-7]}
    assert op_device_times(tmp_path) == {"fusion.7": pytest.approx(2.5e-6)}


_GPU_TRACE = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "Stream #13(Compute)"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 4000000
             stats { metadata_id: 10 str_value: "jit_step(5)" }
             stats { metadata_id: 11 str_value: "fusion.1" }
             stats { metadata_id: 12 str_value: "jit(step)/sweep_sums/dot" } }
    events { metadata_id: 1 offset_ps: 2000000 duration_ps: 4000000
             stats { metadata_id: 10 str_value: "jit_step(5)" }
             stats { metadata_id: 11 str_value: "fusion.2" }
             stats { metadata_id: 12 str_value: "jit(step)/tracker/x" } }
    events { metadata_id: 2 offset_ps: 10000000 duration_ps: 1000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "cutlass_gemm" } }
  event_metadata { key: 2 value { id: 2 name: "MemcpyD2H" } }
  stat_metadata { key: 10 value { id: 10 name: "hlo_module" } }
  stat_metadata { key: 11 value { id: 11 name: "hlo_op" } }
  stat_metadata { key: 12 value { id: 12 name: "prefix" } }
}
"""


def test_trace_reduction_on_a_gpu_layout_trace(tmp_path):
    """The H100 layout: kernels on Stream lines with hlo_* and scope stats."""
    from jax.profiler import ProfileData

    from slam_process_tpu.utils.device_timing import (
        device_busy,
        module_device_times,
        op_device_times,
        scope_device_times,
    )

    (tmp_path / "g.xplane.pb").write_bytes(
        ProfileData.text_proto_to_serialized_xspace(_GPU_TRACE))
    assert module_device_times(tmp_path) == {
        "jit_step": [pytest.approx(8e-6)]}
    assert op_device_times(tmp_path) == {
        "fusion.1": pytest.approx(4e-6), "fusion.2": pytest.approx(4e-6)}
    scopes = scope_device_times(tmp_path, ("sweep_sums", "tracker"))
    assert scopes == {"sweep_sums": pytest.approx(4e-6),
                      "tracker": pytest.approx(4e-6),
                      "copies": pytest.approx(1e-6)}
    busy, span = device_busy(tmp_path)
    assert busy == pytest.approx(7e-6)      # [0, 6) and [10, 11) us
    assert span == pytest.approx(11e-6)
