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
