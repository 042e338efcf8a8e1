"""The port's native control renderer against the JAX package's (CPU).

Both packages build the same C++ source (the port keeps a copy) with the same flags, so
the port's native output must equal JAX's native output bit for bit; against JAX's
numpy path it agrees to 1e-6 (float32 rounding, and the native path's zero tail beyond
7 radii). Covered: masked direct and indirect forces, random masks from a generator,
blobs at and past the frame's edge, distractors, and no mass at all.
"""

import dataclasses
import re

import numpy as np
import pytest

from goal_force_tpu.data import control_signal as jcs

from goal_force_tpu_torch import native as tnative
from goal_force_tpu_torch.data import control_signal as tcs

F, H, W = 9, 40, 56

SPECS = {
    "both_forces": dict(force=200, angle_deg=30, x_pos=0.3, y_pos=0.5, target_force=100,
                        target_angle_deg=90, target_x_pos=0.7, target_y_pos=0.4,
                        projectile_mass=2.0, projectile_xy_px=(15, 16), target_mass=3.0,
                        target_xy_px=(33, 12)),
    "direct_masked": dict(force=-1, angle_deg=0, x_pos=0.5, y_pos=0.5, target_force=150,
                          target_angle_deg=200, target_x_pos=0.2, target_y_pos=0.9,
                          projectile_mass=1.0, projectile_xy_px=(3, 4)),
    "indirect_masked": dict(force=390, angle_deg=315, x_pos=0.9, y_pos=0.1, target_force=-1,
                            target_angle_deg=0, target_x_pos=0, target_y_pos=0,
                            target_mass=4.0, target_xy_px=(50, 38)),
    "at_the_edges": dict(force=400, angle_deg=180, x_pos=0.0, y_pos=1.0, target_force=30,
                         target_angle_deg=45, target_x_pos=1.0, target_y_pos=0.0,
                         projectile_mass=4.0, projectile_xy_px=(0, 0), target_mass=1.0,
                         target_xy_px=(W, H), distractor_masses=(2.5, -1, 3.0),
                         distractor_xy_px=((-30, 10), (5, 5), (W + 20, H + 20))),
    "no_mass": dict(force=120, angle_deg=90, x_pos=0.5, y_pos=0.2, target_force=80,
                    target_angle_deg=270, target_x_pos=0.5, target_y_pos=0.8),
}
MASKS = {"none": (0.0, 0.0, 0.0), "random": (0.3, 0.3, 0.5)}


def _render(mod, spec, backend, masks, seed):
    p_direct, p_indirect, p_mass = masks
    return mod.render_control_video(
        mod.ControlSpec(**spec), F, H, W, min_force=30, max_force=400, min_mass=1.0,
        max_mass=4.0, min_indirect_force=20, max_indirect_force=300,
        p_mask_out_direct=p_direct, p_mask_out_indirect=p_indirect,
        p_mask_out_masses=p_mass, rng=np.random.default_rng(seed), backend=backend)


@pytest.mark.parametrize("masks", list(MASKS), ids=list(MASKS))
@pytest.mark.parametrize("name", list(SPECS))
def test_native_equals_jax_native_bit_for_bit(name, masks):
    for seed in range(3):
        got = _render(tcs, SPECS[name], "native", MASKS[masks], seed)
        want = _render(jcs, SPECS[name], "native", MASKS[masks], seed)
        assert got.dtype == np.float32 and got.shape == (F, H, W, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, _render(jcs, SPECS[name], "numpy", MASKS[masks], seed),
                                   atol=1e-6)
        np.testing.assert_array_equal(_render(tcs, SPECS[name], "numpy", MASKS[masks], seed),
                                      _render(jcs, SPECS[name], "numpy", MASKS[masks], seed))


def test_auto_is_native_where_it_builds():
    spec = SPECS["both_forces"]
    assert tnative.native() is not None
    np.testing.assert_array_equal(_render(tcs, spec, "auto", MASKS["none"], 0),
                                  _render(tcs, spec, "native", MASKS["none"], 0))
    assert not np.array_equal(_render(tcs, spec, "auto", MASKS["none"], 0),
                              _render(tcs, spec, "numpy", MASKS["none"], 0))


def test_the_source_is_the_jax_packages(tmp_path):
    """The two C++ files differ only in their comments."""
    from goal_force_tpu import native as jnative

    def code(path):
        return re.sub(r"//[^\n]*", "", open(path).read()).split()

    assert code(tnative.SRC) == code(jnative._SRC)
    assert tnative.library_path().parent == tnative.BUILD_DIR
    assert tnative.library_path().parent.parent.name == "build"


def test_native_raises_where_it_does_not_build(monkeypatch):
    monkeypatch.setattr(tnative, "native", lambda: None)
    with pytest.raises(RuntimeError, match="native renderer unavailable"):
        _render(tcs, SPECS["no_mass"], "native", MASKS["none"], 0)
    got = _render(tcs, SPECS["no_mass"], "auto", MASKS["none"], 0)
    np.testing.assert_array_equal(got, _render(tcs, SPECS["no_mass"], "numpy", MASKS["none"], 0))


def test_a_failed_build_returns_none(monkeypatch, tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", broken)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    tnative.native.cache_clear()
    try:
        assert tnative.native() is None
        assert tnative.build_error
    finally:
        monkeypatch.undo()
        tnative.native.cache_clear()
    assert tnative.native() is not None


def test_spec_fields_equal_jax():
    assert [f.name for f in dataclasses.fields(tcs.ControlSpec)] == \
        [f.name for f in dataclasses.fields(jcs.ControlSpec)]
