"""kernel_profile's SASS section count (`count_sections`), which PERF.md's
instructions a pixel rest on, on a listing in cuobjdump's format, and its
reader of ptxas's lines for one entry (`ptxas_of`)."""
from qoi_tpu_torch.kernel_profile import count_sections

_LISTING = """
        code for sm_90a
                Function : _ZN12stage_tile_kernelILi1EEEv
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;          /* 0x0000000000007b1d */
        /*0030*/              @!P0 BRA 0x80 ;                             /* 0x0000000000008947 */
        /*0040*/               @P1 ATOMS.OR RZ, [R2], R3 ;                /* 0x000000030200738c */
        /*0050*/                   BAR.ARV 0x1, 0x40 ;                    /* 0x000000000000791d */
        /*0060*/                   BAR.RED.POPC RZ, 0x0 ;                 /* 0x0000000000007b1d */
        /*0070*/              @!UP0 EXIT ;                                /* 0x000000000000894d */
        /*0080*/                   BRA 0x80;                              /* 0xfffffffc00fc7947 */
                ..........
                Function : _ZN11slide_kernelEv
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
        /*0010*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def test_sections_end_at_block_barriers():
    """Instructions counted once each (not their encoding lines), with
    predicates; a section ends at BAR.SYNC or BAR.RED and keeps it;
    BAR.ARV (an arrive) ends none; kernels without "stage" are skipped."""
    assert count_sections(_LISTING) == {
        "_ZN12stage_tile_kernelILi1EEEv": [3, 4, 2]}


def test_no_barrier_is_one_section():
    listing = _LISTING.replace("BAR.SYNC.DEFER_BLOCKING 0x0", "NOP").replace(
        "BAR.RED.POPC RZ, 0x0", "NOP")
    assert count_sections(listing) == {"_ZN12stage_tile_kernelILi1EEEv": [9]}


def test_sections_take_the_resolve_kernel():
    """With SASS_KEYS, the resolve scan's kernel (and an older checkout's
    one-pass entry 5) is counted beside the staging kernels."""
    from qoi_tpu_torch.kernel_profile import SASS_KEYS
    listing = _LISTING.replace("stage_tile_kernelILi1EEEv",
                               "GLOBAL__N_114resolve_kernelENS_4ArgsE")
    assert count_sections(listing) == {}
    assert count_sections(listing, SASS_KEYS) == {
        "_ZN12GLOBAL__N_114resolve_kernelENS_4ArgsE": [3, 4, 2]}
    old = _LISTING.replace("stage_tile_kernelILi1EEEv",
                           "one_pass_kernelILi5EEEvNS_4ArgsE")
    assert list(count_sections(old, SASS_KEYS)) == [
        "_ZN12one_pass_kernelILi5EEEvNS_4ArgsE"]


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115one_pass_kernelILi4EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115one_pass_kernelILi4EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 57 registers, used 1 barriers, 16416 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114resolve_kernelENS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114resolve_kernelENS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 125 registers, used 1 barriers, 144 bytes smem
""".splitlines()


def test_ptxas_of_takes_the_named_entry_only():
    from qoi_tpu_torch.kernel_profile import ptxas_of
    assert ptxas_of(_PTXAS_LOG, "resolve_kernel") == [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 125 registers, used 1 barriers, 144 bytes smem"]
    assert ptxas_of(_PTXAS_LOG, "numeric_scan_kernel") == []
