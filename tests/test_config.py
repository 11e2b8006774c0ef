"""Config loader/validation tests (reference config.json schema parity)."""

import json

import pytest

from qkd_ldpc_tpu.config import Config, RQBERParams, config_from_dict, load_config


def _ref_style_dict(**overrides):
    raw = {
        "threads_number": 16,
        "trials_number": 5000,
        "use_config_simulation_seed": True,
        "simulation_seed": 777,
        "interactive_mode": False,
        "sum_product_max_iterations": 100,
        "use_dense_matrices": False,
        "trace_qkd_ldpc": False,
        "trace_sum_product": False,
        "trace_sum_product_llr": False,
        "enable_sum_product_msg_llr_threshold": True,
        "sum_product_msg_llr_threshold": 100.0,
        "code_rate_QBER_parameters": [
            {"code_rate": 0.95, "QBER_begin": 0.005, "QBER_end": 0.05, "QBER_step": 0.0005},
            {"code_rate": 0.36, "QBER_begin": 0.12, "QBER_end": 0.135, "QBER_step": 0.0005},
            {"code_rate": 0.58, "QBER_begin": 0.06, "QBER_end": 0.075, "QBER_step": 0.0005},
        ],
    }
    raw.update(overrides)
    return raw


def test_reference_schema_loads():
    cfg = config_from_dict(_ref_style_dict())
    assert cfg.trials_number == 5000
    assert cfg.simulation_seed == 777
    assert cfg.sum_product_max_iterations == 100
    assert cfg.enable_sum_product_msg_llr_threshold
    assert cfg.sum_product_msg_llr_threshold == 100.0
    # Sorted ascending by code rate (reference config.cpp:102-106).
    rates = [p.code_rate for p in cfg.r_qber_parameters]
    assert rates == sorted(rates) == [0.36, 0.58, 0.95]


def test_seed_fallback_to_time():
    cfg = config_from_dict(_ref_style_dict(use_config_simulation_seed=False))
    assert cfg.simulation_seed != 777


def test_load_from_file(tmp_path):
    p = tmp_path / "config.json"
    p.write_text(json.dumps(_ref_style_dict()))
    assert load_config(p).trials_number == 5000


def test_missing_file():
    with pytest.raises(FileNotFoundError):
        load_config("/nonexistent/config.json")


def test_empty_file(tmp_path):
    p = tmp_path / "config.json"
    p.write_text("")
    with pytest.raises(ValueError, match="empty"):
        load_config(p)


@pytest.mark.parametrize(
    "overrides,match",
    [
        (dict(threads_number=0), "threads"),
        (dict(trials_number=0), "trials"),
        (dict(sum_product_max_iterations=0), "iterations"),
        (dict(sum_product_msg_llr_threshold=0.0), "threshold"),
        (dict(code_rate_QBER_parameters=[]), "empty"),
    ],
)
def test_validation_errors(overrides, match):
    with pytest.raises((ValueError, KeyError), match=match):
        config_from_dict(_ref_style_dict(**overrides))


@pytest.mark.parametrize(
    "row",
    [
        {"code_rate": 1.5, "QBER_begin": 0.1, "QBER_end": 0.2, "QBER_step": 0.01},
        {"code_rate": 0.5, "QBER_begin": 0.2, "QBER_end": 0.1, "QBER_step": 0.01},
        {"code_rate": 0.5, "QBER_begin": 0.1, "QBER_end": 0.2, "QBER_step": -1.0},
        {"code_rate": 0.5, "QBER_begin": 0.1, "QBER_end": 0.2, "QBER_step": 0.5},
    ],
)
def test_rate_table_validation(row):
    with pytest.raises(ValueError):
        config_from_dict(_ref_style_dict(code_rate_QBER_parameters=[row]))


def test_extension_validation():
    with pytest.raises(ValueError, match="decoder"):
        Config(
            r_qber_parameters=(RQBERParams(0.5, 0.01, 0.1, 0.01),),
            decoder="bogus",
        ).validate()


@pytest.mark.parametrize("key,value", [("backend", "pallas"),
                                       ("prng", "pallas"),
                                       ("backend", "cuda"),
                                       ("prng", "rbg")])
def test_removed_kernel_options_raise(key, value):
    """Configs asking for the removed Pallas kernels ("backend": "pallas",
    "prng": "pallas") or any other unknown choice fail loudly; nothing
    falls back to the XLA decoder or the threefry stream silently."""
    with pytest.raises(ValueError, match="Unsupported"):
        config_from_dict(_ref_style_dict(**{key: value}))


def test_backend_and_prng_naming_what_runs_accepted():
    """"backend": "auto"/"xla" and "prng": "threefry" name what always
    runs, so older configs that spell them out still load."""
    for extra in ({"backend": "auto"}, {"backend": "xla"},
                  {"prng": "threefry"}):
        assert config_from_dict(_ref_style_dict(**extra)).trials_number == 5000
    assert not hasattr(Config(), "backend")
    assert not hasattr(Config(), "prng")
