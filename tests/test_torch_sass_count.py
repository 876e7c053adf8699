"""tools/sass_count.py's reading of cuobjdump output, on a hand-written
listing: functions, labels, the step loop, the classes and the steps a
trip.  (The tool itself disassembles a built library on a machine with
the CUDA toolkit.)"""

from superman_tpu_torch.tools import sass_count

LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_117ryser_walk_kernelILi8ELi1EEEvPKxxPKfS4_iiPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
.L_x_0:
        /*0010*/                   FADD R2, R2, 1 ;
        /*0020*/              @!P1 BRA `(.L_x_0) ;
.L_x_1:
        /*0030*/                   LDS.128 R4, [R12] ;
        /*0040*/                   LDS.64 R8, [R12+0x10] ;
        /*0050*/                   FADD R8, R8, R4 ;
        /*0060*/                   FFMA R9, R5, R0, R9 ;
""" + "".join(f"        /*{0x70 + 16 * i:04x}*/                   FMUL R9, R9, R8 ;\n"
              for i in range(14)) + """\
        /*0150*/                   FLO.U32 R3, R6 ;
        /*0160*/                   NOP ;
        /*0170*/               @P0 BRA 0x30 ;
        /*0180*/                   EXIT ;
"""


def test_step_loop_of_a_listing():
    funcs = sass_count.functions(LISTING)
    assert list(funcs) == ["ryser_walk_kernel<8,1>"]
    insns, labels = funcs["ryser_walk_kernel<8,1>"]
    assert labels == {".L_x_0": 0x10, ".L_x_1": 0x30}
    assert len(sass_count.loops(insns, labels)) == 2
    per_step, steps, opcodes, loop = sass_count.step_loop(insns, labels, 8, 1)
    # 14 FMULs over the 7 of an N_PAD=8 product tree: two steps a trip
    assert steps == 2
    assert opcodes["FMUL"] == 14 and "NOP" not in opcodes
    assert per_step == {"fp64": 0, "fp32": 8, "lds32": 0, "lds64": 0.5,
                        "lds128": 0.5, "mem": 0, "branch": 0.5, "other": 0.5,
                        "total": 10}
    assert len(loop) == 21


def test_demangle_writes_every_template_argument():
    """An int or bool template argument is written as its number, so
    ryser_walk_kernel's per-chunk and block-reduced instantiations have
    names of their own."""
    head = "_ZN12_GLOBAL__N_117ryser_walk_kernelILi32ELi0EL"
    assert sass_count.demangle(head + "b0EEEvPKxxPKdS4_iiiPd") \
        == "ryser_walk_kernel<32,0,0>"
    assert sass_count.demangle(head + "b1EEEvPKxxPKdS4_iiiPd") \
        == "ryser_walk_kernel<32,0,1>"
    assert sass_count.demangle("_ZN12_GLOBAL__N_117ryser_batch_kernel"
                               "ILi24ELi3EEEvPKdS2_iiPd") \
        == "ryser_batch_kernel<24,3>"


def test_tree_multiplies_by_tier():
    assert sass_count.tree_muls(32, 0) == sass_count.tree_muls(32, 1) == 31
    assert sass_count.tree_muls(32, 3) == 16 + 3 * 15
