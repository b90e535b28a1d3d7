// The encoding of a WHERE clause as a postfix program, shared by K1
// (preagg_fused2.cu) and K5 (joinagg_scalar.cu).  ops/preagg_fused2.py
// `_lower_pred` writes it; keep the two in sync.
//
// Program rows (PRED_W int32 each): (opcode, a1, ..., a8)
//   P_CMP      (tag, is_float, a_kind, a_val, a_vin, b_kind, b_val, b_vin);
//              tag 0..5 = eq ne lt le gt ge; kind 0 = column (val = data
//              input), 1 = constant (val = int32 value, or float32 bits
//              when is_float); vin = validity input, -1 = never NULL
//   P_NULLTEST (isnull, vin)   P_BOOLCOL (din, vin)   P_CONST (value)
//   P_AND / P_OR (binary, Kleene)   P_NOT
// Inputs are read by their element type (DT_*).

#pragma once

namespace {

constexpr int PRED_W = 9;
enum { P_CMP = 1, P_NULLTEST, P_BOOLCOL, P_CONST, P_AND, P_OR, P_NOT };
// plane element types
enum { DT_I32, DT_F32, DT_I64, DT_BOOL, DT_I16 };

}  // namespace
