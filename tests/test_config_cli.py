"""Config and CLI surface tests."""

import pytest

from telr_jax.cli import config_from_args, get_args
from telr_jax.config import (ASM10, LIB_TO_SEQ, MAP_ONT, MAP_PB, PRESETS,
                             default_config)


def test_presets_registry():
    assert set(PRESETS) == {"map-pb", "map-ont", "asm10", "lib2seq"}
    assert ASM10.min_identity == 0.8
    assert LIB_TO_SEQ.k < MAP_PB.k  # homology search is more sensitive


def test_read_preset_selection():
    assert default_config("pacbio").read_preset is MAP_PB
    assert default_config("ont").read_preset is MAP_ONT


def test_validate_rejects_bad_presets():
    import dataclasses
    from telr_jax.config import TELRConfig
    cfg = TELRConfig(presets="nanopore")
    with pytest.raises(ValueError):
        cfg.validate()


def test_cli_defaults_match_reference(tmp_path):
    reads = tmp_path / "r.fa"
    reads.write_text(">r\nACGT\n")
    args = get_args(["-i", str(reads), "-r", str(reads), "-l", str(reads)])
    # reference defaults: TELR_input.py:176-254
    assert args.presets == "pacbio"
    assert args.polish_iterations == 1
    assert args.gap == 20 and args.overlap == 20
    assert args.flank_len == 500
    assert args.af_flank_interval == 100 and args.af_flank_offset == 200
    assert args.af_te_interval == 50 and args.af_te_offset == 50
    cfg = config_from_args(args)
    cfg.validate()
    assert cfg.liftover.flank_gap_max == 20
    assert cfg.af.flank_offset == 200


def test_cli_missing_file_exits():
    with pytest.raises(SystemExit):
        get_args(["-i", "/nonexistent", "-r", "/nonexistent",
                  "-l", "/nonexistent"])
