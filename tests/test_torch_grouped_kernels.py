"""The port's grouped kernels (one launch over a list of leaves) on the
CPU: the numpy tables each wrapper hands its CUDA kernel by value, the
arena its outputs are views into, and the grouped entry points'
plain path — ``sophia_update_group``, ``quantize_group`` and
``dequant_accumulate_group`` against the per-leaf plain versions, the JAX
package's ``ref.py`` and the Pallas kernels in interpret mode — and their
callers, Sophia's step, ``QBlock.encode`` and ``QBlock.accumulate``.
tests/test_torch_kernels_cuda.py holds the CUDA kernels against the same
plain versions on the card.

Tolerances:
  * sophia_update (group and per leaf): bitwise equal to the per-leaf
    plain version (the same PyTorch ops); 1e-6 max(1, |x|) against
    ``ref.py`` and the Pallas kernel (the same f32 expression under XLA);
    NaN where the reference gives NaN — ``jnp.maximum`` and ``jnp.clip``
    carry NaN through.
  * quantize (group) and ``QBlock.encode``: q and scale bitwise equal to
    the per-leaf plain version and to ``ref.py`` (exact k + 0.5 ties,
    all-zero blocks, ragged tails); against the interpret-mode Pallas
    kernel, scales within one ulp (XLA's jit divides by 127 as a multiply
    by 1/127) and q equal wherever the scales are, as
    tests/test_torch_qblock.py states it.  A block holding NaN or +-inf
    gets the reference's NaN or inf scale (its codes are a NaN cast to
    int8, which no framework defines, and are not compared).
  * dequant_accumulate (group) and ``QBlock.accumulate``: bitwise equal to
    the per-leaf plain version; 4 B u sum_i |w_i s_i q_i| per element
    against the reference (u = 2^-24: B f32 products summed in another
    order).
  * matmul_fused's problem table: its dtype codes, the 16-byte rule
    counted in bytes and the per-dtype output arena, exact; its plain
    group over mixed dtypes bitwise the per-problem plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transport as JT
from repro.kernels.fused_agg import ref as jax_fa_ref
from repro.kernels.fused_agg.kernel import (
    dequant_accumulate as jax_dequant_pallas,
)
from repro.kernels.qblock import ref as jax_qb_ref
from repro.kernels.qblock.kernel import quantize as jax_quantize_pallas
from repro.kernels.sophia_update import ref as jax_sophia_ref
from repro.kernels.sophia_update.kernel import (
    sophia_update as jax_sophia_pallas,
)
from repro_torch.convert import params_from_numpy
from repro_torch.core import transport as T
from repro_torch.core.transport import qblock as qblock_codec
from repro_torch.kernels import grouped
from repro_torch.kernels.fused_agg import kernel as fak
from repro_torch.kernels.fused_agg.kernel import (
    dequant_accumulate, dequant_accumulate_group, dequant_accumulate_plain,
)
from repro_torch.kernels.ns_ortho import kernel as mfk
from repro_torch.kernels.qblock import kernel as qbk
from repro_torch.kernels.qblock.kernel import (
    quantize, quantize_group, quantize_plain,
)
from repro_torch.kernels.sophia_update import kernel as suk
from repro_torch.kernels.sophia_update.kernel import (
    sophia_update, sophia_update_group, sophia_update_plain,
)
from repro_torch.optim import sophia
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten,
)

U = 2.0 ** -24
KW = dict(b1=0.9, rho=0.05, eps=1e-12)
# per-client leaf shapes of a narrow ViT block and of the CNN, stacked
# over a cohort of 3: matrices, vectors, a 4-D conv kernel, ragged sizes
LEAF_SHAPES = [(3, 16, 48), (3, 48), (3, 16, 16), (3, 64, 16), (3, 16),
               (3, 3, 3, 3, 8), (3, 8), (3, 1, 1, 8, 16), (3, 10),
               (3, 7, 9)]


# ------------------------------------------------------------- the tables

def _fake_ptrs(n, width, base=0x7F0000000000, step=1 << 20):
    return (np.uint64(base) + np.arange(n * width, dtype=np.uint64)
            * np.uint64(step)).reshape(n, width)


def test_table_capacities_fit_the_launch_parameters():
    assert suk.LEAF.itemsize == 56 and suk.HEADER.itemsize == 32
    assert fak.LEAF.itemsize == 56 and fak.HEADER.itemsize == 32
    assert suk.MAX_LEAVES == (32764 - 32) // 56 == 584
    assert fak.MAX_LEAVES == (32764 - 32) // 56 == 584
    for mod in (suk, fak):
        assert mod.TABLE_BYTES <= grouped.PARAM_LIMIT
        assert mod.TABLE_BYTES + mod.LEAF.itemsize > grouped.PARAM_LIMIT


# ------------------------------------------- matmul_fused's dtype fields

def _codes(flags):
    """(lhs, rhs, aux, out) dtype codes of a problem's flags."""
    return tuple((flags >> shift) & 3 for shift in (
        mfk.DT_LHS, mfk.DT_RHS, mfk.DT_AUX, mfk.DT_OUT))


@pytest.mark.parametrize("dtypes,out,want", [
    # lhs, rhs, aux -> out: the record's codes (0 f32, 1 bf16, 2 f16)
    (("float32", "float32", None), None, (0, 0, 0, 0)),
    (("bfloat16", "float32", None), "float32", (1, 0, 0, 0)),
    (("float32", "float32", "bfloat16"), "bfloat16", (0, 0, 1, 1)),
    (("float16", "bfloat16", "float32"), None, (2, 1, 0, 2)),
    (("float32", "float16", "float16"), "float16", (0, 2, 2, 2)),
])
def test_matmul_fused_problem_row_dtype_codes(dtypes, out, want):
    """The output is lhs's dtype unless the problem names one; the
    layout flags below the codes are those of the f32 operands."""
    dl, dr, dx = (None if d is None else getattr(torch, d) for d in dtypes)
    lhs, rhs = torch.empty((2, 16, 24), dtype=dl), torch.empty(
        (2, 24, 32), dtype=dr)
    aux = None if dx is None else torch.empty((2, 16, 32), dtype=dx)
    row = mfk.problem_row(lhs, rhs, aux, 1.0, 0.0, 0,
                          None if out is None else getattr(torch, out))
    flags = row[20]
    assert _codes(flags) == want
    assert flags & 0xFF == mfk.problem_row(
        lhs.float(), rhs.float(), None if aux is None else aux.float(),
        1.0, 0.0, 0)[20] & 0xFF
    (table, _), = mfk.group_tables([row])
    rec = table[mfk.HEADER_BYTES:].view(mfk.PROBLEM)[0]
    assert _codes(int(rec["flags"])) == want


@pytest.mark.parametrize("dtype", [torch.float64, torch.int8,
                                   torch.float8_e4m3fn])
def test_matmul_fused_problem_row_refuses_other_dtypes(dtype):
    x = torch.empty((4, 4))
    y = torch.empty((4, 4), dtype=dtype)
    for args in ((y, x, None), (x, y, None), (x, x, y)):
        with pytest.raises(TypeError, match="float32, bfloat16 and float16"):
            mfk.problem_row(*args, 1.0, 0.0, 0)
    with pytest.raises(TypeError, match="float32, bfloat16 and float16"):
        mfk.problem_row(x, x, None, 1.0, 0.0, 0, dtype)


@pytest.mark.parametrize("case,args,want", [
    # (ptr, (sb, sx, sk), ext_x, k, batch, itemsize) -> (kc, vec): a
    # 16-byte run holds 4 f32 or 8 bf16/f16 elements
    ("f32 rows of 4", (4096, (16, 4, 1), 4, 4, 2, 4), (True, True)),
    ("2-byte rows of 4 (8 B)", (4096, (16, 4, 1), 4, 4, 2, 2),
     (True, False)),
    ("2-byte rows of 8", (4096, (64, 8, 1), 8, 8, 2, 2), (True, True)),
    ("2-byte k-major, k stride 8", (4096, (64, 1, 8), 8, 8, 2, 2),
     (False, True)),
    ("2-byte k-major, k stride 12", (4096, (96, 1, 12), 12, 8, 2, 2),
     (False, False)),
    ("2-byte base 8-aligned", (4104, (64, 8, 1), 8, 8, 2, 2),
     (True, False)),
    ("2-byte batch stride 4", (4096, (4, 8, 1), 8, 8, 2, 2),
     (True, False)),
    ("2-byte batch stride 4, batch 1", (4096, (4, 8, 1), 8, 8, 1, 2),
     (True, True)),
    ("2-byte identity expand, stride 0", (4096, (0, 16, 1), 16, 16, 5, 2),
     (True, True)),
    ("2-byte single row", (4096, (27, 27, 1), 1, 27, 1, 2), (True, True)),
    ("the CNN's 27-wide rows, 2-byte", (4096, (729, 27, 1), 27, 27, 2, 2),
     (True, False)),
])
def test_matmul_fused_vec_rule_counts_bytes(case, args, want):
    assert mfk.operand_flags(*args) == want, case


def test_matmul_fused_output_rule_counts_bytes():
    """A 4-element run of a 2-byte aux is 8 bytes: its base must be 8-byte
    aligned (16 for f32), its rows and batch 4-element strided."""
    lhs, rhs = torch.empty((2, 8, 8)), torch.empty((2, 8, 8))
    for dtype, offset, want in ((torch.float32, 0, True),
                                (torch.float32, 2, False),
                                (torch.bfloat16, 4, True),
                                (torch.bfloat16, 2, False),
                                (torch.float16, 0, True)):
        aux = torch.empty(2 * 64 + offset, dtype=dtype)[offset:].view(2, 8,
                                                                      8)
        flags = mfk.problem_row(lhs, rhs, aux, 1.0, 1.0, 0)[20]
        assert bool(flags & mfk.O_VEC) == (aux.data_ptr() % (
            4 * aux.element_size()) == 0) == want, (dtype, offset)


def test_matmul_fused_tables_order_problems_by_mainloop():
    """A problem whose 2-byte operand takes 16-byte copies runs the
    widening mainloop: the table keeps such problems apart from the f32
    ones of the same layout (then longest k first), as the kernel's
    dispatch reads them."""
    g = torch.empty((2, 16, 24))
    gh = torch.empty((2, 16, 24), dtype=torch.bfloat16)
    q = torch.empty((2, 16, 16))
    qh = torch.empty((2, 16, 16), dtype=torch.bfloat16)
    narrow = torch.empty((2, 16, 27), dtype=torch.bfloat16)[:, :, :24]
    rows = [mfk.problem_row(q, g, None, 1.0, 0.0, 0),        # f32
            mfk.problem_row(qh, g, None, 1.0, 0.0, 0),       # widened lhs
            mfk.problem_row(q, gh, None, 1.0, 0.0, 0),       # widened rhs
            mfk.problem_row(q, narrow, None, 1.0, 0.0, 0)]   # element loads
    flags = np.array([r[20] for r in rows], dtype=np.int32)
    loops = mfk.mainloop(flags)
    assert [bool(x & mfk.RAW_LOOP) for x in loops] == [False, True, True,
                                                        False]
    (_, idx), = mfk.group_tables(rows)
    assert [bool(loops[i] & mfk.RAW_LOOP) for i in idx] == sorted(
        (bool(x & mfk.RAW_LOOP) for x in loops), reverse=True)


def test_matmul_fused_plain_group_writes_each_problem_dtype():
    """The CPU group over mixed dtypes (SOAP's forms at a bf16
    state_dtype): bitwise the per-problem plain version, each output in
    its problem's dtype (lhs's by default)."""
    r = np.random.default_rng(4)
    g = torch.from_numpy(r.standard_normal((2, 12, 20)).astype(np.float32))
    lf = torch.from_numpy(r.standard_normal((2, 12, 12)).astype(
        np.float32)).bfloat16()
    ql = torch.from_numpy(r.standard_normal((2, 12, 12)).astype(
        np.float32)).half()
    problems = [(g, g.transpose(1, 2), lf, 0.05, 0.95, torch.bfloat16),
                (ql.transpose(1, 2), g, None, 1.0, 0.0, torch.float32),
                (ql, g, None, 1.0, 0.0)]
    got = mfk.matmul_fused_group(problems)
    assert [x.dtype for x in got] == [torch.bfloat16, torch.float32,
                                      torch.float16]
    for p, x in zip(problems, got):
        want = mfk.matmul_fused_plain(*p[:3], alpha=p[3], beta=p[4],
                                      out_dtype=p[5] if len(p) > 5 else None)
        assert torch.equal(x, want)
    assert torch.equal(got[0], (0.05 * (g @ g.transpose(1, 2))
                                + 0.95 * lf.float()).bfloat16())


def test_sophia_tables_records_chunk_prefixes_and_header():
    numels = np.array([4096, 1, 0, 12288 + 3, 4100, 8])
    ptrs = _fake_ptrs(len(numels), 5)
    ptrs[4, 2] += np.uint64(4)          # h misaligned: scalar accesses
    (table, idx), = suk.leaf_tables(ptrs, numels, **KW)
    assert table.nbytes == suk.TABLE_BYTES
    assert idx.tolist() == [0, 1, 3, 4, 5]          # the empty leaf dropped
    head = table[:suk.HEADER.itemsize].view(suk.HEADER)[0]
    chunks = [1, 1, 4, 2, 1]
    assert (head["num_leaves"], head["total_chunks"]) == (5, sum(chunks))
    assert head["b1"] == np.float32(0.9)
    assert head["omb1"] == np.float32(1 - 0.9)   # the plain version's constant
    assert (head["rho"], head["eps"]) == (np.float32(0.05), np.float32(1e-12))
    recs = table[suk.HEADER.itemsize:].view(suk.LEAF)
    assert recs["chunk_start"][:5].tolist() == list(np.cumsum(chunks)
                                                    - chunks)
    for j, name in enumerate(("g", "m", "h", "d", "m_out")):
        assert recs[name][:5].tolist() == ptrs[idx, j].tolist()
    assert recs["numel"][:5].tolist() == numels[idx].tolist()
    # numel % 4 and 16-byte alignment of all five pointers decide the flag
    assert recs["flags"][:5].tolist() == [1, 0, 0, 0, 1]
    assert not table[suk.HEADER.itemsize + 5 * suk.LEAF.itemsize:].any()


def test_sophia_tables_split_at_the_record_limit():
    n = 2 * suk.MAX_LEAVES + 7
    numels = np.full(n, 5000)
    numels[3] = 0
    tables = suk.leaf_tables(_fake_ptrs(n, 5), numels, **KW)
    assert [len(i) for _, i in tables] == [suk.MAX_LEAVES, suk.MAX_LEAVES, 6]
    assert sorted(i for _, idx in tables for i in idx) == [
        i for i in range(n) if i != 3]
    small = suk.leaf_tables(_fake_ptrs(7, 5), np.full(7, 9000), **KW,
                            capacity=3)
    assert [len(i) for _, i in small] == [3, 3, 1]
    for table, idx in small:
        head = table[:suk.HEADER.itemsize].view(suk.HEADER)[0]
        recs = table[suk.HEADER.itemsize:].view(suk.LEAF)
        assert head["num_leaves"] == len(idx)
        assert head["total_chunks"] == 3 * len(idx)
        assert recs["chunk_start"][:len(idx)].tolist() == [0, 3, 6][:len(idx)]


@pytest.mark.parametrize("block", [128, 256])
def test_dequant_tables_records_item_prefixes_and_flags(block):
    ns = np.array([768, 10, 0, 1000, 256, 48])
    ptrs = _fake_ptrs(len(ns), 3)
    ptrs[4, 0] += np.uint64(4)      # q aligned to 4 bytes but not to 16
    ptrs[5, 2] += np.uint64(8)      # out not 16-byte aligned
    (table, idx), = fak.leaf_tables(ptrs, ns, 0xABC0, 5, block)
    assert table.nbytes == fak.TABLE_BYTES
    assert idx.tolist() == [0, 1, 3, 4, 5]
    head = table[:fak.HEADER.itemsize].view(fak.HEADER)[0]
    items = [-(-n // 4) for n in ns[idx]]             # 4 outputs an item
    assert (head["num_leaves"], head["total_items"]) == (5, sum(items))
    assert (head["w"], head["clients"], head["block"]) == (0xABC0, 5, block)
    recs = table[fak.HEADER.itemsize:].view(fak.LEAF)
    assert recs["item_start"][:5].tolist() == list(np.cumsum(items) - items)
    assert recs["nb"][:5].tolist() == [-(-n // block) for n in ns[idx]]
    for j, name in enumerate(("q", "scale", "out")):
        assert recs[name][:5].tolist() == ptrs[idx, j].tolist()
    # 10 alone does not fill whole items; leaf 4's q is aligned for the
    # kernel's 4-byte loads, leaf 5's out not for float4 stores
    assert recs["flags"][:5].tolist() == [1, 0, 1, 1, 0]


def test_dequant_tables_split_at_the_record_limit():
    n = fak.MAX_LEAVES + 2
    tables = fak.leaf_tables(_fake_ptrs(n, 3), np.full(n, 128), 0, 2, 128)
    assert [len(i) for _, i in tables] == [fak.MAX_LEAVES, 2]
    for table, idx in tables:
        head = table[:fak.HEADER.itemsize].view(fak.HEADER)[0]
        assert head["total_items"] == 32 * len(idx)


def test_quantize_table_capacity_fits_the_launch_parameters():
    assert qbk.LEAF.itemsize == 48 and qbk.HEADER.itemsize == 16
    assert qbk.MAX_LEAVES == (32764 - 16) // 48 == 682
    assert qbk.TABLE_BYTES <= grouped.PARAM_LIMIT
    assert qbk.TABLE_BYTES + qbk.LEAF.itemsize > grouped.PARAM_LIMIT


@pytest.mark.parametrize("block", [128, 256])
def test_quantize_tables_records_item_prefixes_header_and_flags(block):
    rows = np.array([5, 5, 3, 2, 5, 0, 4, 2])
    ns = np.array([576, 10, 0, 1000, 192, 64, 300, 48])
    ptrs = _fake_ptrs(len(ns), 3)
    ptrs[4, 0] += np.uint64(8)      # x not 16-byte aligned
    ptrs[6, 1] += np.uint64(4)      # q 4-byte aligned: still wide
    ptrs[7, 1] += np.uint64(2)      # q not 4-byte aligned
    (table, idx), = qbk.leaf_tables(ptrs, rows, ns, block, 1e-12)
    assert table.nbytes == qbk.TABLE_BYTES
    assert idx.tolist() == [0, 1, 3, 4, 6, 7]   # no elements, no clients
    head = table[:qbk.HEADER.itemsize].view(qbk.HEADER)[0]
    nb = [-(-n // block) for n in ns[idx]]
    items = [r * b for r, b in zip(rows[idx], nb)]   # a quant block a row
    assert (head["num_leaves"], head["total_items"]) == (6, sum(items))
    assert (head["block"], head["eps"]) == (block, np.float32(1e-12))
    recs = table[qbk.HEADER.itemsize:].view(qbk.LEAF)
    assert recs["item_start"][:6].tolist() == list(np.cumsum(items) - items)
    assert recs["nb"][:6].tolist() == nb
    assert recs["n"][:6].tolist() == ns[idx].tolist()
    for j, name in enumerate(("x", "q", "scale")):
        assert recs[name][:6].tolist() == ptrs[idx, j].tolist()
    # n % 4, x's 16-byte and q's 4-byte alignment decide the flag
    assert recs["flags"][:6].tolist() == [1, 0, 1, 0, 1, 0]
    assert not table[qbk.HEADER.itemsize + 6 * qbk.LEAF.itemsize:].any()


def test_quantize_tables_split_at_the_record_limit():
    n = 2 * qbk.MAX_LEAVES + 3
    ns = np.full(n, 300)
    ns[5] = 0
    tables = qbk.leaf_tables(_fake_ptrs(n, 3), np.full(n, 2), ns, 128,
                             1e-12)
    assert [len(i) for _, i in tables] == [qbk.MAX_LEAVES, qbk.MAX_LEAVES, 2]
    assert sorted(i for _, idx in tables for i in idx) == [
        i for i in range(n) if i != 5]
    for table, idx in tables:
        head = table[:qbk.HEADER.itemsize].view(qbk.HEADER)[0]
        recs = table[qbk.HEADER.itemsize:].view(qbk.LEAF)
        assert head["num_leaves"] == len(idx)
        assert head["total_items"] == 6 * len(idx)      # 2 rows x 3 blocks
        assert recs["item_start"][:len(idx)].tolist() == list(
            range(0, 6 * len(idx), 6))


def test_quantize_layout_cuts_contiguous_codes_and_scales():
    """The int8 codes and the f32 scales of a call come from two arenas of
    one ``arena_layout`` each (counted in elements); every view is a
    contiguous (rows, n) / (rows, nb) tensor at its own offset."""
    shapes = ((5, 576), (5, 10), (5, 576), (3, 0), (2, 1000))
    (q_off, q_runs, q_total), (s_off, s_runs, s_total) = qbk._layout(
        shapes, 128)
    assert (q_off % grouped.OUT_ALIGN == 0).all()
    assert (s_off % grouped.OUT_ALIGN == 0).all()
    qs, = grouped.arena_views(torch.arange(q_total).to(torch.int8), q_runs,
                              len(shapes))
    ss, = grouped.arena_views(torch.arange(s_total, dtype=torch.float32),
                              s_runs, len(shapes))
    for (r, n), q, s, qo, so in zip(shapes, qs, ss, q_off, s_off):
        assert q.dtype == torch.int8 and tuple(q.shape) == (r, n)
        assert s.dtype == torch.float32 and tuple(s.shape) == (r, -(-n // 128))
        assert q.is_contiguous() and s.is_contiguous()
        if s.numel():
            assert float(s.reshape(-1)[0]) == so
            assert int(q.reshape(-1)[0]) == np.int8(qo % 256)
    assert qbk._layout(shapes, 128) is qbk._layout(shapes, 128)   # cached


def test_split_tables_refuses_a_32_bit_overflow():
    header = np.zeros(1, suk.HEADER)
    recs = np.zeros(2, suk.LEAF)
    with pytest.raises(ValueError, match="32-bit"):
        grouped.split_tables(header, recs, [2 ** 30, 2 ** 30],
                             "chunk_start", 4)


@pytest.mark.parametrize("copies", [1, 2])
def test_arena_layout_groups_shapes_and_aligns_every_output(copies):
    shapes = ((3, 16, 48), (3, 10), (3, 16, 48), (), (3, 10), (0, 4),
              (3, 16, 48))
    offsets, numels, total, _ = grouped.arena_layout(shapes, copies)
    assert offsets.shape == (copies, len(shapes))
    assert numels.tolist() == [2304, 30, 2304, 1, 30, 0, 2304]
    assert (offsets % grouped.OUT_ALIGN == 0).all()
    # outputs of one shape lie side by side, copy after copy
    assert offsets[0, [0, 2, 6]].tolist() == [0, 2304, 4608]
    assert offsets[0, 4] - offsets[0, 1] == 32
    if copies == 2:
        assert offsets[1, 0] == 3 * 2304
    arena = torch.arange(total, dtype=torch.float32)
    views = grouped.arena_views(arena, grouped.arena_layout(shapes,
                                                            copies)[3],
                                len(shapes), copies)
    assert len(views) == copies
    spans = []
    for c in range(copies):
        for v, s, o in zip(views[c], shapes, offsets[c]):
            assert tuple(v.shape) == s and v.is_contiguous()
            if v.numel():
                assert float(v.reshape(-1)[0]) == o   # a view at its offset
                spans.append((o, o + v.numel()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    end = spans[-1][1]
    assert total == end + (-end) % grouped.OUT_ALIGN


def test_tree_unflatten_inverts_tree_leaves():
    tree = {"w": torch.zeros(2), "blocks": [{"b": torch.ones(3)},
                                            {"a": torch.ones(1)}],
            "head": None, "a": (torch.zeros(4),)}
    leaves = [x + 1 for x in tree_leaves(tree)]
    back = tree_unflatten(tree, leaves)
    assert back["head"] is None
    for got, want in zip(tree_leaves(back), leaves):
        assert got is want


# ---------------------------------------------------------- sophia_update

def _sophia_leaves(seed, shapes=LEAF_SHAPES):
    r = np.random.default_rng(seed)
    out = []
    for s in shapes:
        g = r.standard_normal(s).astype(np.float32)
        m = r.standard_normal(s).astype(np.float32)
        h = np.abs(r.standard_normal(s)).astype(np.float32) * 50.0
        flat = h.reshape(-1)
        flat[::3] = 0.0                 # h = 0: the clip saturates
        flat[1::7] = 1e-3
        out.append((g, m, h))
    return out


def _assert_rel(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.all(np.abs(got - want) <= 1e-6 * np.maximum(1.0, np.abs(want))
                  ), what


def test_sophia_group_matches_per_leaf_plain_ref_and_pallas():
    leaves = _sophia_leaves(0)
    gs, ms, hs = ([torch.from_numpy(x[i]) for x in leaves] for i in range(3))
    before = sophia_update.launches
    ds, mos = sophia_update_group(gs, ms, hs, **KW)
    assert sophia_update.launches == before          # the CPU's plain path
    assert len(ds) == len(mos) == len(leaves)
    for (g, m, h), d, mo in zip(leaves, ds, mos):
        want_d, want_m = sophia_update_plain(*map(torch.from_numpy, (g, m, h)),
                                             **KW)
        assert d.dtype == mo.dtype == torch.float32
        assert torch.equal(d, want_d) and torch.equal(mo, want_m)
        assert torch.equal(d, sophia_update(*map(torch.from_numpy,
                                                 (g, m, h)), **KW)[0])
        ref = jax_sophia_ref.sophia_update(g, m, h, **KW)
        pal = jax_sophia_pallas(jnp.asarray(g), jnp.asarray(m),
                                jnp.asarray(h), interpret=True, **KW)
        for want in (ref, pal):
            _assert_rel(d, want[0], g.shape)
            _assert_rel(mo, want[1], g.shape)
        assert np.all(np.abs(d.numpy().reshape(-1)[::3]) == 0.05)


@pytest.mark.parametrize("where", ["h", "g"])
def test_sophia_group_nan_and_inf_follow_the_reference(where):
    """NaN in h or g stays NaN in d (``jnp.maximum``/``jnp.clip`` carry it
    through; a max that dropped NaN would map h = NaN to eps and d to
    +-rho); +-inf saturates or vanishes as the reference's does."""
    g, m, h = _sophia_leaves(1, [(3, 64)])[0]
    x = h if where == "h" else g
    x[0, :4] = [np.nan, np.inf, -np.inf, np.nan]
    x[1, :2] = [np.inf, -np.inf]
    t = [torch.from_numpy(v) for v in (g, m, h)]
    (d,), (mo,) = sophia_update_group([t[0]], [t[1]], [t[2]], **KW)
    gf = jnp.asarray(g)
    m_ref = 0.9 * jnp.asarray(m) + (1.0 - 0.9) * gf
    d_ref = jnp.clip(m_ref / jnp.maximum(jnp.asarray(h), 1e-12), -0.05, 0.05)
    for got, want in ((d, d_ref), (mo, m_ref)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        inf = np.isinf(want)
        np.testing.assert_array_equal(got[inf], want[inf])
        ok = np.isfinite(want)
        _assert_rel(got[ok], want[ok], where)
    assert np.isnan(d.numpy()[0, [0, 3]]).all()
    if where == "h":      # +inf h: d = m'/inf = 0; -inf h: max(-inf, eps)
        assert d.numpy()[0, 1] == 0.0
        assert abs(d.numpy()[0, 2]) == np.float32(0.05)


def test_sophia_group_validates_and_dispatches():
    x = torch.ones(4)
    assert sophia_update_group([], [], []) == ([], [])
    with pytest.raises(ValueError, match="as many"):
        sophia_update_group([x, x], [x], [x])
    with pytest.raises(ValueError, match="shape"):
        sophia_update_group([x, x], [x, x], [x, torch.ones(5)])
    with pytest.raises(ValueError, match="several devices"):
        sophia_update_group([x, torch.ones(4, device="meta")], [x, x], [x, x])
    meta = torch.ones(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sophia_update_group([meta], [meta], [meta])


def _nested(shapes, lead=()):
    return {"blocks": [{"w": (*lead, *shapes[0]), "b": (*lead, *shapes[1])},
                       {"w": (*lead, *shapes[2])}],
            "head": {"b": (*lead, *shapes[3])}}


def test_sophia_step_makes_one_group_call_and_keeps_the_tree(monkeypatch):
    """Sophia's update flattens the trees once, makes one grouped call and
    rebuilds the gradients' structure: the result equals the per-leaf
    plain version, leaf by leaf, on a nested tree."""
    r = np.random.default_rng(5)
    shapes = _nested([(12, 20), (20,), (3, 3, 2, 8), (5,)], lead=(2,))

    def tree(scale=1.0):
        return params_from_numpy(jax.tree.map(
            lambda s: (r.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple)), "cpu")

    params, grads = tree(), tree()
    state = {"m": tree(), "h": tree_map(torch.abs, tree(10.0))}
    calls = []
    real = sophia.sophia_update_group

    def spy(gs, ms, hs, **kw):
        calls.append(len(gs))
        return real(gs, ms, hs, **kw)

    monkeypatch.setattr(sophia, "sophia_update_group", spy)
    opt = sophia.make(weight_decay=0.1)
    d, new = opt.update(grads, state, params, step=0, lead=1)
    assert calls == [4]
    assert tree_map(lambda x: x.shape, d) == tree_map(lambda x: x.shape,
                                                      grads)
    for g, m, h, p, got_d, got_m in zip(*map(tree_leaves, (
            grads, state["m"], state["h"], params, d, new["m"]))):
        want_d, want_m = sophia_update_plain(g, m, h)
        assert torch.equal(got_m, want_m)
        assert torch.equal(got_d, want_d + 0.1 * p)


# --------------------------------------------------------------- quantize

def _tied_rows(rows, n, block, seed):
    """(rows, n) f32 with a block of exact k + 0.5 ties at scale 2^-3
    (round half to even), an all-zero block where n allows, random blocks,
    and a ragged tail whenever n % block != 0."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((rows, n)) * 3.0).astype(np.float32)
    b0 = min(block, n)
    ties = (r.integers(-126, 126, (rows, b0)) + 0.5) * 0.125
    ties[:, 0] = 127 * 0.125                 # amax -> scale = 2^-3
    x[:, :b0] = ties
    if n > 2 * block:
        x[:, block:2 * block] = 0.0
    return x


def _quant_leaves(block, seed):
    """Per-client rows of LEAF_SHAPES and of a ViT-Tiny block's leaves
    at S=2, ragged and tied."""
    shapes = [(s[0], int(np.prod(s[1:]))) for s in LEAF_SHAPES]
    shapes += [(2, 192 * 576), (2, 192), (2, 768), (2, 100)]
    return [_tied_rows(r, n, block, seed + i)
            for i, (r, n) in enumerate(shapes)]


def _ref_rows(x, block):
    """ref.py's quantize, one client's row at a time (the reference's
    vmap), q trimmed to the n values that ship."""
    n = x.shape[1]
    out = [jax_qb_ref.quantize(jnp.asarray(row), block=block) for row in x]
    return (np.stack([np.asarray(q).reshape(-1)[:n] for q, _ in out]),
            np.stack([np.asarray(s) for _, s in out]))


@pytest.mark.parametrize("block", [128, 256])
def test_quantize_group_bitwise_matches_per_leaf_plain_and_ref(block):
    leaves = _quant_leaves(block, block)
    before = quantize.launches
    coded = quantize_group([torch.from_numpy(x) for x in leaves],
                           block=block)
    assert quantize.launches == before                # the CPU's plain path
    assert len(coded) == len(leaves)
    ties = 0
    for x, (q, s) in zip(leaves, coded):
        rows, n = x.shape
        assert q.dtype == torch.int8 and tuple(q.shape) == (rows, n)
        assert s.dtype == torch.float32
        assert tuple(s.shape) == (rows, -(-n // block))
        for want in (quantize_plain(torch.from_numpy(x), block=block),
                     quantize(torch.from_numpy(x), block=block)):
            assert torch.equal(q, want[0]) and torch.equal(s, want[1])
        want_q, want_s = _ref_rows(x, block)
        np.testing.assert_array_equal(q.numpy(), want_q)
        np.testing.assert_array_equal(s.numpy(), want_s)
        xs = x[:, :min(block, n)] / want_s[:, :1]
        ties += int(np.sum(np.abs(xs - np.round(xs)) == 0.5))
    assert ties > 0                       # half-to-even was exercised


@pytest.mark.parametrize("block", [128, 256])
def test_quantize_group_matches_pallas_interpret_within_one_ulp(block):
    """The Pallas kernel in interpret mode divides by 127 as XLA's jit
    does, through the reciprocal: scales within one ulp, q equal wherever
    the scales agree and within one elsewhere."""
    leaves = [_tied_rows(2, n, block, n) for n in (300, 4096, 192, 10)]
    coded = quantize_group([torch.from_numpy(x) for x in leaves],
                           block=block)
    for x, (q, s) in zip(leaves, coded):
        n = x.shape[1]
        for i in range(2):
            pq, ps = jax_quantize_pallas(jnp.asarray(x[i]), block=block,
                                         interpret=True)
            pq = np.asarray(pq).reshape(-1)[:n].astype(np.int32)
            ps = np.asarray(ps)
            got_q, got_s = q.numpy()[i].astype(np.int32), s.numpy()[i]
            assert np.all(np.abs(got_s.view(np.int32)
                                 - ps.view(np.int32)) <= 1)
            same = np.repeat(got_s == ps, block)[:n]
            np.testing.assert_array_equal(got_q[same], pq[same])
            assert np.all(np.abs(got_q - pq) <= 1)


def test_quantize_group_nan_and_inf_scales_follow_the_reference():
    """``jnp.max`` carries NaN into the block's scale and ``jnp.maximum``
    keeps it (a max that dropped NaN would give the block a finite
    scale); +-inf gives an inf scale.  Other blocks are untouched."""
    x = _tied_rows(3, 700, 128, 9)
    x[0, 5] = np.nan
    x[1, 130] = np.inf
    x[1, 300] = -np.inf
    x[2, 650] = np.nan
    x[2, 651] = np.inf
    (q, s), = quantize_group([torch.from_numpy(x)])
    want_q, want_s = _ref_rows(x, 128)
    got = s.numpy()
    nan = np.isnan(want_s)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan], want_s[~nan])
    assert np.isnan(got[[0, 2], [0, 5]]).all()
    assert np.isinf(got[1, [1, 2]]).all()
    ok = np.repeat(np.isfinite(want_s), 128, axis=1)[:, :700]
    np.testing.assert_array_equal(q.numpy()[ok], want_q[ok])


def test_quantize_group_validates_and_dispatches():
    x = torch.ones(2, 10)
    assert quantize_group([]) == []
    with pytest.raises(ValueError, match="rows, n"):
        quantize_group([x, torch.ones(10)])
    with pytest.raises(ValueError, match="block must be"):
        quantize_group([x], block=0)
    with pytest.raises(ValueError, match="several devices"):
        quantize_group([x, torch.ones(2, 10, device="meta")])
    with pytest.raises(ValueError, match="unsupported device"):
        quantize_group([torch.ones(2, 10, device="meta")])


# ----------------------------------------------------- dequant_accumulate

def _coded(shapes, block, seed):
    r = np.random.default_rng(seed)
    out = []
    for s in shapes:
        x = (r.standard_normal((s[0], int(np.prod(s[1:])))) * 2).astype(
            np.float32)
        out.append(quantize_plain(torch.from_numpy(x), block=block))
    return out


def _accumulate_bound(q, s, w, block):
    n = q.shape[1]
    ws = np.abs(w[:, None] * s)
    per = np.repeat(ws, block, axis=1)[:, :n] * np.abs(q.astype(np.float32))
    return 4 * q.shape[0] * U * per.sum(0) + 1e-30


@pytest.mark.parametrize("block", [128, 256])
def test_dequant_group_matches_per_leaf_plain_ref_and_pallas(block):
    coded = _coded(LEAF_SHAPES, block, block)
    w = np.random.default_rng(7).uniform(0.2, 1.5, 3).astype(np.float32)
    wt = torch.from_numpy(w)
    before = dequant_accumulate.launches
    outs = dequant_accumulate_group([q for q, _ in coded],
                                    [s for _, s in coded], wt, block=block)
    assert dequant_accumulate.launches == before
    assert len(outs) == len(coded)
    for (q, s), got in zip(coded, outs):
        n = q.shape[1]
        assert tuple(got.shape) == (n,) and got.dtype == torch.float32
        assert torch.equal(got, dequant_accumulate_plain(q, s, wt,
                                                         block=block))
        assert torch.equal(got, dequant_accumulate(q, s, wt, block=block))
        nb = s.shape[1]
        q3 = np.pad(q.numpy(), ((0, 0), (0, nb * block - n))).reshape(
            3, nb, block)
        args = (jnp.asarray(q3), jnp.asarray(s.numpy()), jnp.asarray(w))
        bound = _accumulate_bound(q.numpy(), s.numpy(), w, block)
        for want in (jax_fa_ref.dequant_accumulate(*args),
                     jax_dequant_pallas(*args, interpret=True)):
            want = np.asarray(want).reshape(-1)[:n]
            assert np.all(np.abs(got.numpy() - want) <= bound)


def test_dequant_group_validates_and_dispatches():
    (q, s), = _coded([(2, 10)], 128, 0)
    w = torch.ones(2)
    assert dequant_accumulate_group([], [], w) == []
    with pytest.raises(ValueError, match="scale per q"):
        dequant_accumulate_group([q, q], [s], w)
    with pytest.raises(ValueError, match="shape mismatch"):
        dequant_accumulate_group([q], [s], torch.ones(3))
    with pytest.raises(ValueError, match="weights"):
        dequant_accumulate_group([q], [s], torch.ones(2, 1))
    with pytest.raises(TypeError, match="int8"):
        dequant_accumulate_group([q, q.float()], [s, s], w)
    with pytest.raises(ValueError, match="several devices"):
        dequant_accumulate_group([q], [s], torch.ones(2, device="meta"))


STACK = {"w": (4, 12, 20), "stem": (4, 3, 3, 2, 8), "gn_scale": (4, 8),
         "blocks": [{"b1": (4, 200)}, {"w": (4, 16, 48), "b": (4, 48)}]}


def test_qblock_accumulate_is_one_group_call_matching_jax(monkeypatch):
    r = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda s: (r.standard_normal(s) * 0.1).astype(np.float32), STACK,
        is_leaf=lambda x: isinstance(x, tuple))
    w = np.asarray([1.0, 0.5, 0.25, 0.8], np.float32)
    jc = JT.QBlock(block=128, use_pallas=False)
    tc = T.resolve_codec("qblock")
    jmsg = jax.vmap(jc.encode)(tree)
    tmsg = tc.encode(params_from_numpy(tree, "cpu"))
    calls = []
    real = qblock_codec.dequant_accumulate_group

    def spy(qs, scales, weights, **kw):
        calls.append(len(qs))
        return real(qs, scales, weights, **kw)

    monkeypatch.setattr(qblock_codec, "dequant_accumulate_group", spy)
    got = tc.accumulate(tmsg, torch.from_numpy(w))
    assert calls == [len(tree_leaves(tmsg.leaves))]
    want = jc.accumulate(jmsg, jnp.asarray(w))
    for wl, gl, ml in zip(jax.tree.leaves(want), tree_leaves(got),
                          tree_leaves(tmsg.leaves)):
        assert tuple(gl.shape) == wl.shape
        assert torch.equal(gl.reshape(-1), tc.accumulate_leaf(
            ml, torch.from_numpy(w)).reshape(-1))
        bound = _accumulate_bound(ml.parts["q"].numpy(),
                                  ml.parts["scale"].numpy(), w, 128)
        assert np.all(np.abs(gl.numpy().reshape(-1)
                             - np.asarray(wl).reshape(-1)) <= bound)


def test_qblock_accumulate_refuses_a_mixed_block_message():
    """A message frames all its leaves with one block; one whose leaves
    disagree is refused rather than decoded under the wrong framing."""
    r = np.random.default_rng(4)
    x = {k: torch.from_numpy(r.standard_normal(s).astype(np.float32))
         for k, s in (("a", (3, 300)), ("b", (3, 5, 40)))}
    leaves = {k: T.QBlock(block=256 if k == "b" else 128).encode_leaf(v)
              for k, v in x.items()}
    with pytest.raises(ValueError, match=r"one block, got \[128, 256\]"):
        T.QBlock(block=128).accumulate(T.WireMsg("qblock", leaves),
                                       torch.ones(3))
    one = T.QBlock(block=256)
    msg = T.WireMsg("qblock", {k: one.encode_leaf(v) for k, v in x.items()})
    got = T.QBlock(block=128).accumulate(msg, torch.ones(3))   # 256 framing
    for k, m in msg.leaves.items():
        assert torch.equal(got[k].reshape(-1), dequant_accumulate_plain(
            m.parts["q"], m.parts["scale"], torch.ones(3), block=256))


def test_qblock_encode_is_one_group_call_matching_jax(monkeypatch):
    """``QBlock.encode`` quantizes the whole stacked tree in one grouped
    call and keeps its structure; every leaf's message is bitwise the
    JAX codec's under ``vmap`` and ``encode_leaf``'s."""
    r = np.random.default_rng(6)
    tree = jax.tree.map(
        lambda s: (r.standard_normal(s) * 0.1).astype(np.float32), STACK,
        is_leaf=lambda x: isinstance(x, tuple))
    jc = JT.QBlock(block=128, use_pallas=False)
    tc = T.resolve_codec("qblock")
    calls = []
    real = qblock_codec.quantize_group

    def spy(xs, **kw):
        calls.append(len(xs))
        return real(xs, **kw)

    monkeypatch.setattr(qblock_codec, "quantize_group", spy)
    ttree = params_from_numpy(tree, "cpu")
    tmsg = tc.encode(ttree)
    assert calls == [len(tree_leaves(ttree))]
    assert T.wire_bytes(tmsg) == JT.wire_bytes(jax.vmap(jc.encode)(tree))
    jmsg = jax.vmap(jc.encode)(tree)
    flat = tree_flatten_with_path(tmsg.leaves)
    assert [p for p, _ in flat] == [p for p, _ in tree_flatten_with_path(
        ttree)]
    for jl, (path, tl), x in zip(jmsg.leaves, flat, tree_leaves(ttree)):
        assert tl.kind == "qblock" and tl.extra == jl.extra == 128
        assert tl.shape == tuple(x.shape) and tl.dtype == x.dtype
        np.testing.assert_array_equal(tl.parts["q"].numpy(),
                                      np.asarray(jl.parts["q"]),
                                      err_msg=str(path))
        np.testing.assert_array_equal(tl.parts["scale"].numpy(),
                                      np.asarray(jl.parts["scale"]))
        one = tc.encode_leaf(x)
        assert torch.equal(one.parts["q"], tl.parts["q"])
        assert torch.equal(one.parts["scale"], tl.parts["scale"])
