"""``bluefog_tpu_torch.kernel_ablations`` derives its kernel variants from
the committed source by text edits; every edit must still apply (checked
on the CPU: no build, no GPU)."""

import shutil

import pytest

from bluefog_tpu_torch import kernel_ablations as KA


@pytest.mark.parametrize("name", sorted(KA.VARIANTS))
def test_variant_edits_apply(name):
    cu, h = KA.variant_sources(name)
    assert (cu, h) != KA.variant_sources("as-is") or name == "as-is"
    assert "WGMMA_N32" not in h


def test_rows_32_adds_the_n32_product():
    _, h = KA.variant_sources("k3-rows-32")
    assert "m64n32k16" in h and "float (&d)[16]" in h


def test_stale_edit_is_refused(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(KA._nvcc.CSRC_DIR, csrc)
    cu = csrc / "flash_attention.cu"
    cu.write_text(cu.read_text().replace("exp2f(fmaf(s[i], scale_log2", "exp2f(fmaf(s[i], c"))
    with pytest.raises(ValueError, match="no-exp"):
        KA.variant_sources("no-exp", csrc)


def _tile(cu, name):
    """The text of one tile struct (FwdTile, DqTile, DkvTile)."""
    start = cu.index(f"struct {name} {{")
    return cu[start:cu.index("};", start)]


def test_stages_3_leaves_k2_at_two_stages():
    cu, _ = KA.variant_sources("stages-3")
    assert "kStages = 3;" in _tile(cu, "FwdTile")
    assert "kStages = 3;" in _tile(cu, "DkvTile")
    assert "kStages = 2;" in _tile(cu, "DqTile")


def test_k2_variants_edit_k2():
    as_is, _ = KA.variant_sources("as-is")
    cu, _ = KA.variant_sources("k2-keys-64")
    assert "kKeys = 64;" in _tile(cu, "DqTile")
    assert _tile(cu, "FwdTile") == _tile(as_is, "FwdTile")
    cu, _ = KA.variant_sources("k2-no-delta")
    assert "3 * T::kRowBytes" not in cu and "dot + delta[" in cu
    cu, _ = KA.variant_sources("k2-one-wait")
    assert "wgmma_wait<1>" not in cu
    assert cu.count("wgmma_commit();") == as_is.count("wgmma_commit();") - 1


@pytest.mark.parametrize("name, gone", [
    ("no-exp", "exp2_ftz(fmaf(s[i]"),                       # K2's P
    ("no-second-product", "  hopper::wgmma_rs_tb(acc, &ds["),
    ("head-major", "const int bh = blockIdx.x"),            # K1, K2 and K3
    ("one-tile", "kt * T::kKeys, h, b);"),                  # K1's and K2's producer
])
def test_shared_edits_reach_k2(name, gone):
    as_is, _ = KA.variant_sources("as-is")
    cu, _ = KA.variant_sources(name)
    assert gone in as_is and gone not in cu
