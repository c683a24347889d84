"""Percent of the card's 32-bit integer multiply peak that the window's
plain requests use (those with no span and no profiler, trace.py): the
modular-multiply work of each, from the cell's frozen census of one
request of its length (cells/<workload>.census.json), over (the sum of
their seconds, client encrypt to logits, x peaks.json's int32_mul_per_s).

The cost model counts one modular product as 3 32-bit multiplies (a
64-bit product in two and one for the reduction), and as modular products:
  * a forward NTT row of n points: (n / 2) log2 n butterflies;
  * an inverse NTT row: (n / 2)(log2 n - 1) butterflies and n scalings;
  * a base conversion of B x g_valid source rows into nd digits of tgt
    rows: B n g_valid tgt multiply-adds, plus B n g_valid for the fold
    unless prefolded;
  * every element of an int64 elementwise product of the request's torch
    operations (the modular products outside the three kernels).
The census counts the work as the circuit defines it, so a change that
takes work out of the program raises the share and cannot move the
numerator."""

MULS_PER_PRODUCT = 3


def products(census: dict) -> int:
    total = 0
    for rec, count in census["ntt_fwd"]:
        n = rec["n"]
        total += count * rec["rows"] * (n // 2) * (n.bit_length() - 1)
    for rec, count in census["ntt_inv"]:
        n = rec["n"]
        total += count * rec["rows"] * ((n // 2) * (n.bit_length() - 2) + n)
    for rec, count in census["base_convert"]:
        g = rec["g_valid"]
        total += count * rec["batch"] * rec["n"] * (
            g * rec["tgt"] + (0 if rec["prefolded"] else g))
    total += sum(el for _, el in census["int64_products"])
    return total


def read(record):
    census = record.get("census")
    plain = [r for r, k in zip(record["requests"], record["kinds"])
             if k == "plain"]
    seconds = sum(r["s"] for r in plain)
    if not census or seconds <= 0:
        return None
    by_len = census["lengths"]
    lens = [str(record["lengths"][r["index"]]) for r in plain]
    if any(s not in by_len for s in lens):
        return None
    work = MULS_PER_PRODUCT * sum(products(by_len[s]) for s in lens)
    return 100.0 * work / (seconds * record["peaks"]["int32_mul_per_s"])
