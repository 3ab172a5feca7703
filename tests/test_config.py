"""Config system tests: defaults, merge, dotted update, SNR resolution, sanitize."""

import pytest

from hmsr_tpu.configs import (
    default_config, merge, update, sanitize_config, update_snr_config, lerp,
)


def test_defaults_shape():
    c = default_config()
    assert c.scale == 1
    assert c.mode == "bayer"
    assert c.block_matching.tuning.factors == [1, 2, 4, 4]
    assert c.block_matching.tuning.tile_size == "SNR_based"
    assert c.merging.kernel == "steerable"


def test_merge_and_update():
    c = default_config()
    c2 = merge(c, {"scale": 2, "ica": {"tuning": {"n_iter": 5}}})
    assert c2.scale == 2
    assert c2.ica.tuning.n_iter == 5
    assert c2.ica.tuning.sigma_blur == 0          # untouched sibling survives
    assert c.scale == 1                            # base not mutated
    update(c2, "robustness.tuning.t", 0.2)
    assert c2.robustness.tuning.t == 0.2


@pytest.mark.parametrize("snr,ts", [(10, 64), (20, 32), (28, 16), (100, 16)])
def test_snr_tile_size(snr, ts):
    c = default_config()
    update_snr_config(c, snr)
    assert c.block_matching.tuning.tile_size == ts
    assert c.block_matching.tuning.tile_sizes == [ts, ts, ts, ts // 2]


def test_snr_lerp_endpoints():
    c = default_config()
    update_snr_config(c, 6)
    assert c.merging.tuning.k_detail == pytest.approx(0.33)
    assert c.merging.tuning.k_denoise == pytest.approx(5.0)
    c = default_config()
    update_snr_config(c, 30)
    assert c.merging.tuning.D_th == pytest.approx(0.71)
    assert c.merging.tuning.D_tr == pytest.approx(1.0)


def test_lerp_clamps():
    assert lerp(0, [6, 30], [1.0, 2.0]) == 1.0
    assert lerp(100, [6, 30], [1.0, 2.0]) == 2.0
    assert lerp(18, [6, 30], [1.0, 2.0]) == pytest.approx(1.5)


def test_sanitize_passes_on_valid():
    c = default_config()
    update_snr_config(c, 25)
    sanitize_config(c, (256, 256))


def test_sanitize_rejects_denoiser_without_robustness():
    c = default_config()
    update_snr_config(c, 25)
    c.robustness.enabled = False
    c.robustness.save_mask = False
    c.accumulated_robustness_denoiser.gauss.enabled = True
    with pytest.raises(ValueError):
        sanitize_config(c, (256, 256))


def test_sanitize_rejects_tiny_image():
    c = default_config()
    update_snr_config(c, 10)   # Ts = 64, coarsest level /32 with tile 32
    with pytest.raises(ValueError):
        sanitize_config(c, (64, 64))


# ---------------------------------------------------------------------------
# defaults without PyYAML; removed and unknown implementation options
# ---------------------------------------------------------------------------

import subprocess  # noqa: E402
import sys  # noqa: E402

from hmsr_tpu.configs.params import (  # noqa: E402
    IMPL_CHOICES, REMOVED_KEYS, REMOVED_VALUES)


def test_default_config_needs_no_yaml_package():
    code = ("import sys; sys.modules['yaml'] = None; import hmsr_tpu; "
            "c = hmsr_tpu.default_config(); assert c.scale == 1; print('ok')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"


def test_yaml_only_for_user_files(monkeypatch, tmp_path):
    from hmsr_tpu.configs import load_yaml
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert default_config().merging.kernel == "steerable"
    path = tmp_path / "user.yaml"
    path.write_text("scale: 2\n")
    with pytest.raises(ImportError):
        load_yaml(str(path))


def test_yaml_roundtrip(tmp_path):
    pytest.importorskip("yaml")
    from hmsr_tpu.configs import load_yaml
    c = default_config()
    path = tmp_path / "c.yaml"
    path.write_text(c.to_yaml())
    assert load_yaml(str(path)) == c


def test_default_config_is_a_fresh_copy():
    a = default_config()
    a.block_matching.tuning.factors.append(8)
    a.tpu.pipeline = "scan"
    b = default_config()
    assert b.block_matching.tuning.factors == [1, 2, 4, 4]
    assert b.tpu.pipeline == "auto"


@pytest.mark.parametrize("key", REMOVED_KEYS)
def test_removed_key_rejected(key):
    c = default_config()
    update_snr_config(c, 25)
    c.tpu[key] = True
    with pytest.raises(ValueError, match="removed"):
        sanitize_config(c, (256, 256))


@pytest.mark.parametrize("key,value", REMOVED_VALUES)
def test_removed_value_rejected(key, value):
    c = default_config()
    update_snr_config(c, 25)
    c.tpu[key] = value
    with pytest.raises(ValueError, match="removed"):
        sanitize_config(c, (256, 256))


def test_unknown_impl_value_rejected():
    c = default_config()
    update_snr_config(c, 25)
    c.tpu.grey_impl = "fancy"
    with pytest.raises(ValueError, match="grey_impl"):
        sanitize_config(c, (256, 256))


def test_pipeline_builders_reject_removed_option():
    from hmsr_tpu.models.pipeline import make_pipeline
    from hmsr_tpu.parallel import make_mesh, make_sharded_pipeline
    c = default_config()
    c.tpu.pipeline = "chunked"
    with pytest.raises(ValueError, match="removed"):
        make_pipeline(c, [[0, 1], [1, 2]], [1.0, 1.0, 1.0])
    c = default_config()
    c.tpu.merge_impl = "pallas"
    with pytest.raises(ValueError, match="removed"):
        make_sharded_pipeline(c, [[0, 1], [1, 2]], [1.0, 1.0, 1.0],
                              make_mesh(1, 1))


def test_default_impl_options_are_valid():
    c = default_config()
    for key, value in c.tpu.items():
        assert value in IMPL_CHOICES[key], (key, value)
