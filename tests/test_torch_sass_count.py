"""The SASS loop count behind F1's GELU backward issue bound
(proqa_tpu_torch/sass_count.py), on listings written in both forms the CUDA
tools print: absolute branch targets (cuobjdump) and labels (nvdisasm)."""
from proqa_tpu_torch import sass_count

MANGLED = ("_ZN12_GLOBAL__N_125dense_epilogue_bwd_kernelI13__nv_bfloat16Lb1ELb1ELb1EEEvPKT_S4_"
           "PS2_PfS6_xi")
CUOBJDUMP = """
\tcode for sm_90a
\t\tFunction : MANGLED
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0020*/                   LDG.E.128 R4, desc[UR4][R2.64] ;       /* 0x0000000402047981 */
        /*0030*/                   LDG.E.128 R8, desc[UR4][R12.64] ;      /* 0x000000040c087981 */
        /*0040*/                   MUFU.EX2 R5, R5 ;                      /* 0x0000000500057308 */
        /*0050*/                   STG.E.128 desc[UR4][R14.64], R4 ;      /* 0x000000040e007986 */
        /*0060*/              @P0  BRA 0x20 ;                             /* 0x0000000000000947 */
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;          /* 0x0000000000007b1d */
        /*0080*/               @P1 BRA.U !UP0, 0x70 ;                     /* 0x0000000000001947 */
        /*0090*/                   EXIT ;                                 /* 0x000000000000794d */
        /*00a0*/                   BRA 0xa0;                              /* 0xfffffffc00fc7947 */
\t\tFunction : _Z5otherv
        /*0000*/                   EXIT ;
""".replace("MANGLED", MANGLED)

NVDISASM = """
        .text._Z4loopv:
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_0:
        /*0010*/                   FFMA R1, R1, R1, R1 ;
        /*0020*/                   FADD R2, R2, R1 ;
        /*0030*/               @P0 BRA `(.L_x_0) ;
        /*0040*/                   EXIT ;
"""


def test_largest_loop_of_a_cuobjdump_listing():
    funcs = sass_count.functions(CUOBJDUMP)
    assert set(funcs) == {MANGLED, "_Z5otherv"}
    name = next(n for n in funcs if sass_count.KERNELS["F1 backward GELU"] in n)
    # 0x20 .. 0x60: two 16-byte loads, a MUFU, a 16-byte store and the branch
    assert sass_count.main_loop(funcs[name]) == {
        "instructions": 5, "global_loads_128": 2, "global_stores_128": 1, "mufu": 1}
    assert sass_count.main_loop(funcs["_Z5otherv"]) is None


def test_labelled_loop_of_an_nvdisasm_listing():
    listing = "\t\tFunction : _Z4loopv\n" + NVDISASM
    loop = sass_count.main_loop(sass_count.functions(listing)["_Z4loopv"])
    assert loop == {"instructions": 3, "global_loads_128": 0, "global_stores_128": 0, "mufu": 0}
