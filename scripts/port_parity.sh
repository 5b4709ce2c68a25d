#!/bin/bash
# Port parity: the PyTorch port (--device cpu) against the JAX package
# (W2RAP_PLATFORM=cpu), both on the CPU, through steps 1-7 on the two
# parity configs of scripts/parity_check.sh (200 kb, 24k PE250 pairs,
# K=200) and scripts/parity_repeat.sh (repeat-rich 500 kb: 12 copies of
# a 3 kb repeat, 4 coverage dips, 60k PE250 pairs, seed 7, K=200).
# Needs a box with both packages (jax for the JAX package).
#
#   bash scripts/port_parity.sh [OUT_DIR]
#
# For each config: both CLIs' walls, compare_contigs.py's verdict (must
# read BIT-IDENTICAL CONTIG SETS), then cmp of stats, a.fin.frags.dist
# and the GFA files, and every array of the pe.contig checkpoints.
set -e
cd "$(dirname "$0")/.."
OUT=${1:-${TMPDIR:-/tmp}/port_parity}
FILES="stats a.fin.frags.dist a_contigs_raw.gfa a_contigs_lines.gfa pe_assembly_raw.gfa pe_assembly_lines.gfa"

run_config() {
    local name=$1; shift
    local dir=$OUT/$name
    rm -rf "$dir"
    python scripts/make_synth_fastq.py "$dir" --rlen 250 --insert 500 "$@" > /dev/null
    local reads=$dir/reads_R1.fastq,$dir/reads_R2.fastq
    local t0=$(date +%s%N)
    W2RAP_PLATFORM=cpu python -m w2rap_contigger_tpu -r "$reads" -o "$dir/jax" -p pe -K 200 \
        --dump_perf > "$dir/jax.log" 2>&1
    local t1=$(date +%s%N)
    python -m w2rap_contigger_tpu_torch -r "$reads" -o "$dir/port" -p pe -K 200 \
        --device cpu --dump_perf > "$dir/port.log" 2>&1
    local t2=$(date +%s%N)
    echo "[$name] wall jax_s=$(awk "BEGIN { print ($t1 - $t0) / 1e9 }") port_s=$(awk "BEGIN { print ($t2 - $t1) / 1e9 }")"
    echo "[$name] jax .perf: $(cut -d, -f2,3 "$dir/jax/pe.perf" | tr '\n' ';')"
    echo "[$name] port .perf: $(cut -d, -f2,3 "$dir/port/pe.perf" | tr '\n' ';')"
    python scripts/compare_contigs.py "$dir/port/a.lines.fasta" "$dir/jax/a.lines.fasta" \
        | sed "s/^/[$name] /"
    for f in $FILES; do
        cmp "$dir/jax/$f" "$dir/port/$f"
    done
    python - "$dir/jax" "$dir/port" <<'EOF'
import sys
import numpy as np
a, b = sys.argv[1:]
for name in ("pe.contig.hbv.npz", "pe.contig.paths.npz"):
    za, zb = np.load(f"{a}/{name}"), np.load(f"{b}/{name}")
    assert sorted(za.files) == sorted(zb.files), name
    for key in za.files:
        np.testing.assert_array_equal(zb[key], za[key], err_msg=f"{name}:{key}")
EOF
    echo "[$name] identical: $FILES pe.contig.{hbv,paths}.npz"
}

run_config 200kb --glen 200000 --pairs 24000
run_config repeat500kb --glen 500000 --pairs 60000 --repeats 12 --repeat_len 3000 \
    --dips 4 --seed 7
