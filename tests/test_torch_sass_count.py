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


PTXAS = """ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'
ptxas info    : Function properties for _Z1av
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 128 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 392 bytes cmem[0]
"""


def test_ptxas_report_and_diff():
    """The ptxas report `_build.build` keeps, read kernel by kernel, and two
    builds' reports compared (the existing forms' lines, parent against
    change)."""
    report = sass_count.ptxas_report(PTXAS)
    assert report == {
        "_Z1av": {"registers": 40, "spill_stores": 0, "spill_loads": 0,
                  "resources": "used 1 barriers, 128 bytes smem, 400 bytes cmem[0]"},
        "_Z1bv": {"registers": 255, "spill_stores": 4, "spill_loads": 4,
                  "resources": "used 0 barriers, 392 bytes cmem[0]"}}
    other = {**report, "_Z1bv": {**report["_Z1bv"], "registers": 254}, "_Z1cv": {}}
    assert sass_count.ptxas_diff(report, other) == {
        "differ": ["_Z1bv"], "first_only": [], "second_only": ["_Z1cv"]}
    assert sass_count.ptxas_diff(report, report) == {
        "differ": [], "first_only": [], "second_only": []}
    # a kernel in an anonymous namespace: the same key from two builds
    builds = [PTXAS.replace("_Z1av", f"_ZN49_GLOBAL__N__{h}_16_layer_norm_cu_{g}1kEv")
              for h, g in (("62b87636", "22fc95b7"), ("ca68b704", "0123abcd"))]
    keys = [set(sass_count.ptxas_report(b)) for b in builds]
    assert keys[0] == keys[1] == {"_ZN49_GLOBAL__N___16_layer_norm_cu_1kEv", "_Z1bv"}


def test_sass_diff_by_demangled_name():
    """Two builds' kernels compared by demangled name: label numbers that
    differ between the builds do not count, an instruction that differs
    does."""
    first = sass_count.normalized(sass_count.functions(
        "\t\tFunction : _Z4loopv\n" + NVDISASM + "\t\tFunction : _Z5otherv\n"
        "        /*0000*/                   EXIT ;\n"), ["loop()", "other()"])
    relabelled = NVDISASM.replace(".L_x_0", ".L_x_9")
    second = sass_count.normalized(sass_count.functions(
        "\t\tFunction : _ZN12_GLOBAL__N_14loopEv\n" + relabelled), ["loop()"])
    assert first["loop()"][1] == ".L0" and second["loop()"] == first["loop()"]
    assert sass_count.sass_diff(first, second) == {
        "same": 1, "differ": [], "first_only": ["other()"], "second_only": []}
    changed = {"loop()": [t.replace("FADD", "FMUL") for t in second["loop()"]]}
    assert sass_count.sass_diff(first, changed)["differ"] == ["loop()"]
