#!/bin/bash
# Port parity: the PyTorch port (--device cpu) against the JAX package
# (W2RAP_PLATFORM=cpu), both on the CPU, through steps 1-7 with
# --dump_all, on these configs:
#   200kb         scripts/parity_check.sh (24k PE250 pairs, K=200)
#   repeat500kb   scripts/parity_repeat.sh (12 copies of a 3 kb repeat,
#                 4 coverage dips, 60k PE250 pairs, seed 7, K=200)
#   ecoli         scripts/northstar_ecoli.sh (4.6 Mbp, 550k PE250 pairs,
#                 seed 42, K=260): chip_smoke.py phases 5-6's data
#   ecoli_gaps    4.6 Mbp, 550k PE250 pairs, 12 copies of a 3 kb repeat,
#                 8 coverage dips, seed 7, K=260: chip_smoke.py phase 7's
# Needs a box with both packages (jax for the JAX package).
#
#   bash scripts/port_parity.sh [OUT_DIR [CONFIG ...]]   # default: 200kb repeat500kb
#
# For each config: both CLIs' walls, compare_contigs.py's verdict (must
# read BIT-IDENTICAL CONTIG SETS), then cmp of stats, a.fin.frags.dist
# and the GFA files, and the sha256 of every output file and checkpoint
# array of both runs (scripts/output_hashes.py), which must be equal.
# The JAX run's hashes, with the reads', stay in OUT_DIR/CONFIG/
# jax_hashes.json (chip_smoke.py's EXPECTED table holds the E. coli
# ones).  The E. coli configs count with -d 4 -m 4 in the port's CPU
# run (the same outputs, a quarter of the unbatched count's memory).
set -e
cd "$(dirname "$0")/.."
OUT=${1:-${TMPDIR:-/tmp}/port_parity}
shift || true
CONFIGS=${*:-200kb repeat500kb}
FILES="stats a.fin.frags.dist a_contigs_raw.gfa a_contigs_lines.gfa pe_assembly_raw.gfa pe_assembly_lines.gfa"

# run_config NAME K PORT_EXTRA SYNTH_ARGS...
run_config() {
    local name=$1 k=$2 port_extra=$3; shift 3
    local dir=$OUT/$name
    rm -rf "$dir"
    python scripts/make_synth_fastq.py "$dir" --rlen 250 --insert 500 "$@" > /dev/null
    local reads=$dir/reads_R1.fastq,$dir/reads_R2.fastq
    local t0=$(date +%s%N)
    W2RAP_PLATFORM=cpu python -m w2rap_contigger_tpu -r "$reads" -o "$dir/jax" -p pe -K "$k" \
        --dump_all --dump_perf > "$dir/jax.log" 2>&1
    local t1=$(date +%s%N)
    python -m w2rap_contigger_tpu_torch -r "$reads" -o "$dir/port" -p pe -K "$k" \
        --device cpu --dump_all --dump_perf $port_extra > "$dir/port.log" 2>&1
    local t2=$(date +%s%N)
    echo "[$name] wall jax_s=$(awk "BEGIN { print ($t1 - $t0) / 1e9 }") port_s=$(awk "BEGIN { print ($t2 - $t1) / 1e9 }")"
    echo "[$name] jax .perf: $(cut -d, -f2,3 "$dir/jax/pe.perf" | tr '\n' ';')"
    echo "[$name] port .perf: $(cut -d, -f2,3 "$dir/port/pe.perf" | tr '\n' ';')"
    python scripts/compare_contigs.py "$dir/port/a.lines.fasta" "$dir/jax/a.lines.fasta" \
        | sed "s/^/[$name] /"
    for f in $FILES; do
        cmp "$dir/jax/$f" "$dir/port/$f"
    done
    python scripts/output_hashes.py "$dir/jax" --reads "$dir" > "$dir/jax_hashes.json"
    python scripts/output_hashes.py "$dir/port" --reads "$dir" > "$dir/port_hashes.json"
    cmp "$dir/jax_hashes.json" "$dir/port_hashes.json"
    echo "[$name] identical: $(python -c 'import json, sys; print(len(json.load(open(sys.argv[1]))))' \
        "$dir/jax_hashes.json") hashes" \
        "($FILES, every checkpoint array, the reads)"
}

for config in $CONFIGS; do
    case $config in
    200kb) run_config 200kb 200 "" --glen 200000 --pairs 24000 ;;
    repeat500kb) run_config repeat500kb 200 "" --glen 500000 --pairs 60000 --repeats 12 \
        --repeat_len 3000 --dips 4 --seed 7 ;;
    ecoli) run_config ecoli 260 "-d 4 -m 4" --glen 4600000 --pairs 550000 --seed 42 ;;
    ecoli_gaps) run_config ecoli_gaps 260 "-d 4 -m 4" --glen 4600000 --pairs 550000 \
        --repeats 12 --repeat_len 3000 --dips 8 --seed 7 ;;
    *) echo "unknown config $config" >&2; exit 2 ;;
    esac
done
