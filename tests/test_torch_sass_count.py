"""``utils/sass_count.py``'s parser on a fixed ``cuobjdump -sass`` excerpt:
kernels split at their ``Function :`` headers, predicated instructions
counted under their base opcode (``IMAD.MOV`` as a move), moves, loads,
branches and the uniform
datapath kept out of the integer ALU count."""
from indy_plenum_tpu_torch.utils import sass_count

SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_16kernelEPKhS1_Phi
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;              /* 0x0000000000007919 */
        /*0020*/                   ULDC.64 UR4, c[0x0][0x208] ;    /* 0x0000820000047ab9 */
        /*0030*/              @!PT SHF.R.W.U32.HI R3, R2, 0x7, R2 ;
        /*0040*/               @P0 LOP3.LUT R4, R3, R5, R6, 0x96, !PT ;
        /*0050*/                   IADD3 R4, R3, R5, R6 ;
        /*0060*/                   IMAD.MOV.U32 R7, RZ, RZ, R4 ;
        /*0070*/               @P1 BRA 0x30 ;
        /*0080*/                   EXIT ;
                Function : _ZN12_GLOBAL__N_16otherEv
        /*0000*/                   PRMT R2, R2, 0x123, RZ ;
        /*0010*/                   NOP ;
"""


def test_count_splits_kernels_and_keeps_base_opcodes():
    got = sass_count.count(SASS)
    assert list(got) == ["_ZN12_GLOBAL__N_16kernelEPKhS1_Phi",
                         "_ZN12_GLOBAL__N_16otherEv"]
    first = got["_ZN12_GLOBAL__N_16kernelEPKhS1_Phi"]
    assert first == {"LDC": 1, "S2R": 1, "ULDC": 1, "SHF": 1, "LOP3": 1,
                     "IADD3": 1, "MOV": 1, "BRA": 1, "EXIT": 1}
    assert sass_count.int_alu(first) == 3  # SHF, LOP3, IADD3
    assert sass_count.int_alu(got["_ZN12_GLOBAL__N_16otherEv"]) == 1
