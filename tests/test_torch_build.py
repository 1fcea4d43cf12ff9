"""The kernel build's bookkeeping, on the CPU (no nvcc here): the
``-Xptxas -v`` report kept beside a library, and ``chip_smoke.py``'s reading
of it (registers a thread and spill bytes of each kernel).  The report
lines are nvcc 12.8's for ``csrc/flash_attention_bwd.cu``."""
import sys
from pathlib import Path

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_420ab23414attn_bwd_deltaI13__nv_bfloat16Li16EEEvPKT_S4_Pflii' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_420ab23414attn_bwd_deltaI13__nv_bfloat16Li16EEEvPKT_S4_Pflii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_420ab23415attn_bwd_dq_mmaILi64EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_iiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_420ab23415attn_bwd_dq_mmaILi64EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_iiiff
    24 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_420ab23414attn_bwd_deltaIfLi16EEEvPKT_S3_Pflii' for 'sm_90a'
ptxas info    : Used 26 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_420ab23419attn_bwd_sum_splitsEPKfP13__nv_bfloat16S3_lif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_ptxas_report_is_kept_beside_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.ptxas_report("flash_attention_bwd") == ""
    lib = _build._lib_path(_build.CSRC / "flash_attention_bwd.cu")
    lib.with_suffix(".ptxas.txt").write_text(REPORT)
    assert _build.ptxas_report("flash_attention_bwd") == REPORT


def test_chip_smoke_reads_registers_and_spills_by_kernel():
    assert chip_smoke.ptxas_kernels(REPORT) == {
        "attn_bwd_delta<bf16,16>": {"spill_store_bytes": 0,
                                    "spill_load_bytes": 0, "registers": 26},
        "attn_bwd_dq_mma<64>": {"spill_store_bytes": 20,
                                "spill_load_bytes": 20, "registers": 168},
        "attn_bwd_delta<float,16>": {"registers": 26},
        "attn_bwd_sum_splits": {"spill_store_bytes": 0,
                                "spill_load_bytes": 0, "registers": 32},
    }


# nvcc 12.8's report lines for csrc/selective_scan.cu, two of its four
# kernels: the template's first argument is the element type.
SCAN_REPORT = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__74da2e5e_17_selective_scan_cu_12829b1b21selective_scan_kernelI13__nv_bfloat16Li16EEEvPKT_S4_PKfS6_S6_S6_S6_S6_PS2_Pfiib' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 13312 bytes smem
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__74da2e5e_17_selective_scan_cu_12829b1b21selective_scan_kernelIfLi8EEEvPKT_S3_PKfS5_S5_S5_S5_S5_PS1_Pfiib' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 30720 bytes smem
"""


def test_chip_smoke_reads_the_scans_kernels_by_dtype_and_state_size():
    assert chip_smoke.ptxas_kernels(SCAN_REPORT) == {
        "selective_scan_kernel<bf16,16>": {
            "spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 80},
        "selective_scan_kernel<float,8>": {
            "spill_store_bytes": 4, "spill_load_bytes": 4, "registers": 72},
    }


# The forward's two instantiations for one dtype and state size, serving
# (kSave false) and training (true): a bool template argument mangles as
# Lb0E / Lb1E, and the two must not fold into one entry.
SCAN_SAVE_REPORT = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__74da2e5e_17_selective_scan_cu_12829b1b21selective_scan_kernelI13__nv_bfloat16Li16ELb0EEEvPKT_S4_PKfS6_S6_S6_S6_S6_PS2_Pfiib' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 13312 bytes smem
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__74da2e5e_17_selective_scan_cu_12829b1b21selective_scan_kernelI13__nv_bfloat16Li16ELb1EEEvPKT_S4_PKfS6_S6_S6_S6_S6_PS2_S6_iib' for 'sm_90a'
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 13312 bytes smem
"""


def test_chip_smoke_tells_the_scans_serve_and_train_kernels_apart():
    assert chip_smoke.ptxas_kernels(SCAN_SAVE_REPORT) == {
        "selective_scan_kernel<bf16,16,0>": {
            "spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 80},
        "selective_scan_kernel<bf16,16,1>": {
            "spill_store_bytes": 8, "spill_load_bytes": 8, "registers": 80},
    }


def test_chip_smoke_counts_the_scan_backwards_partials():
    """The scan backward's per-block partials at falcon-mamba-7b's training
    microbatch (B = 4, S = 4,096, Di = 8,192, N = 16, 64 channels a block),
    written and read back: ~0.54 GB, dB and dC nearly all of it."""
    got = chip_smoke.scan_bwd_partial_bytes(4, 4096, 8192, 16, 64)
    dbc = 2 * 4 * 128 * 4 * 4096 * 32
    assert dbc < got < dbc * 1.01
    assert abs(got / 1e9 - 0.54) < 0.005


# The attention's instantiations by mask: the backward's int template
# argument (0 causal, 1 windowed, 2 unmasked) mangles as Li<n>E, the
# forward's bool (causal) as Lb<n>E; each is an entry of its own.
ATTN_MASK_REPORT = """\
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_420ab23417attn_bwd_dkdv_mmaILi64ELi0EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_Pfiiiiiff' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_420ab23417attn_bwd_dkdv_mmaILi64ELi2EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_Pfiiiiiff' for 'sm_90a'
    168 bytes stack frame, 160 bytes spill stores, 140 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__5d1c0e2a_18_flash_attention_cu_7a3f6b2119flash_attention_mmaILi64ELb0EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiifi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


def test_chip_smoke_tells_the_attention_masks_apart():
    assert chip_smoke.ptxas_kernels(ATTN_MASK_REPORT) == {
        "attn_bwd_dkdv_mma<64,0>": {"spill_store_bytes": 0,
                                    "spill_load_bytes": 0, "registers": 168},
        "attn_bwd_dkdv_mma<64,2>": {"spill_store_bytes": 160,
                                    "spill_load_bytes": 140,
                                    "registers": 168},
        "flash_attention_mma<64,0>": {"spill_store_bytes": 0,
                                      "spill_load_bytes": 0,
                                      "registers": 128},
    }


# The pooled gather's instantiations: the element type, the vector width
# and the shard window (kSkipNegative, a bool) each mangle into the name,
# so the unmasked kernel's registers stay readable beside the window's.
POOL_REPORT = """\
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__1f2e3d4c_19_embedding_gather_cu_5a6b7c8d18gather_pool_kernelI13__nv_bfloat16Li8ELb0EEEvPKT_llPKiliPfi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__1f2e3d4c_19_embedding_gather_cu_5a6b7c8d18gather_pool_kernelI13__nv_bfloat16Li8ELb1EEEvPKT_llPKiliPfi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 42 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__1f2e3d4c_19_embedding_gather_cu_5a6b7c8d18gather_pool_kernelIfLi1ELb0EEEvPKT_llPKiliPfi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 0 barriers
"""


def test_chip_smoke_tells_the_pools_shard_window_apart():
    assert chip_smoke.ptxas_kernels(POOL_REPORT) == {
        "gather_pool_kernel<bf16,8,0>": {
            "spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 40},
        "gather_pool_kernel<bf16,8,1>": {
            "spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 42},
        "gather_pool_kernel<float,1,0>": {
            "spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 24},
    }
