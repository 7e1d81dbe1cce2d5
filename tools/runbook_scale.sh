#!/bin/bash
# Full-pipeline runbook at REAL topology (round-3 task 4): random-init
# 24-layer qwen2_moe (60+4 experts) and 27-layer ds2 run the WHOLE
# pipeline; qwen2_moe_57b and mixtral run trace+calibrate+solve at full
# width/expert count but reduced depth (their full-depth synth
# checkpoints are ~90-98 GB fp16 — this host has ~53 GB of disk; the
# honest budget table lives in docs/REPRO.md). All stages run on the CPU
# backend (tools/cpurun.py; 8-device virtual mesh for serve) EXCEPT
# calibrate, which stages layer-by-layer onto the GPU when one is free
# (MXMOE_RUNBOOK_CPU=1 forces CPU there too). Logs per-stage wall time +
# peak RSS to out/runbook_scale/times.tsv for REPRO.md.
#
# Exits non-zero with a FAILED summary when any stage fails (round-4
# verdict weak #2: exit codes 143/1 used to row silently).
#
#   bash tools/runbook_scale.sh [qwen2_moe|ds2|qwen2_moe_57b|mixtral|all]
set -u
cd "$(dirname "$0")/.."
OUT=out/runbook_scale
mkdir -p $OUT
TSV=$OUT/times.tsv
[ -f $TSV ] || echo -e "model\tstage\twall_s\tmax_rss_gb\texit" > $TSV
FAILED_STAGES=""

stage () {  # stage <model> <name> <cmd...>
    local model=$1 name=$2; shift 2
    if grep -qP "^$model\t$name\t.*\t0$" $TSV 2>/dev/null; then
        echo "== skip $model/$name (done)"; return 0
    fi
    echo "== $model/$name: $*"
    local t0=$SECONDS
    python tools/timed_run.py $OUT/.rss-$model-$name "$@" \
        > $OUT/${model}-${name}.log 2>&1
    local rc=$? wall=$((SECONDS - t0))
    local rss=$(cat $OUT/.rss-$model-$name 2>/dev/null)
    echo -e "$model\t$name\t$wall\t$rss\t$rc" >> $TSV
    echo "== $model/$name: ${wall}s rss=${rss}GB exit=$rc"
    if [ $rc -ne 0 ]; then
        FAILED_STAGES="$FAILED_STAGES $model/$name(exit=$rc)"
    fi
    return $rc
}

run_model () {
    local M=$1 L=$2 LITE=${3:-full}
    local G=$OUT/$M/gate/moe-gate.json
    local CK=$OUT/$M/ckpt-hf
    mkdir -p $OUT/$M/gate $OUT/$M/calib $OUT/$M/qconfigs

    # synthetic HF checkpoint, one shard per layer: memory-bounded AND
    # exercises the lazy shard loader at real topology (materializing the
    # 24L pytree via init_params OOMed the host at 118 GB). lite models
    # keep full width/experts but reduced depth (disk budget).
    local LAYERS=""
    [ "$LITE" = lite ] && LAYERS="--layers $L"
    stage $M mkckpt python tools/make_synth_ckpt.py --model $M --out $CK \
        $LAYERS || return 1

    # lite models pass --layers everywhere: the loaders otherwise expect
    # the registry depth and KeyError on the shallow checkpoint
    stage $M trace python tools/cpurun.py -n 1 mxmoe.trace.gate \
        --model $M --ckpt $CK --nsamples 2 --seqlen 512 --out $G \
        $LAYERS || return 1

    # calibrate runs HOST-STAGED ON THE GPU by default (one layer to the
    # device at a time, calibrate.py stage_host; CPU execution of the
    # L x E x 3 GPTQ hot loop is ~40 min/layer = ~16 h at 24L).
    # MXMOE_RUNBOOK_CPU=1 forces the CPU backend (e.g. GPU busy).
    local CAL="python -m"
    [ -n "${MXMOE_RUNBOOK_CPU:-}" ] && CAL="python tools/cpurun.py -n 1"
    stage $M calibrate $CAL mxmoe.quant.calibrate \
        --model $M --ckpt $CK --method gptq-had \
        --qcfg w4a4_g-1_sym w8a8_g-1_sym \
        --nsamples 2 --seqlen 256 --save_dir $OUT/$M/calib \
        $LAYERS || return 1

    local QC=$OUT/$M/qconfigs/$M-w5-r0.5.json
    stage $M solve python tools/cpurun.py -n 1 mxmoe.solver.bits_solver \
        --trace $G \
        --loss w4a4_g-1_sym=$OUT/$M/calib/$M-MOE-layer_out_norm-gptq-had-w4a4_g-1_sym.json \
               w8a8_g-1_sym=$OUT/$M/calib/$M-MOE-layer_out_norm-gptq-had-w8a8_g-1_sym.json \
        --batch 8192 --wbits 5.0 --r 0.5 --runtime_model onelaunch \
        --out $QC || return 1

    # lite models stop after solve: convert doubles their disk footprint
    # and serving at depth-reduced topology adds nothing the qwen2_moe
    # 24L serve doesn't already prove
    [ "$LITE" = lite ] && return 0

    stage $M convert python tools/cpurun.py -n 1 mxmoe.models.convert \
        --model $M --ckpt $CK --out $OUT/$M/ckpt-w5-packed \
        --qconfig $QC --pack-int4 || return 1

    # --decode-attn xla: on the virtual CPU mesh the fused attention
    # kernel would run in the Pallas INTERPRETER (hours of emulation);
    # the quantized GMM kernels stay interpret — they are what the
    # serve stage validates
    # --max-new 4: the stage proves artifact -> reshard -> EP decode on
    # the 8-dev mesh; every interpret-mode kernel call costs ~0.5-1 s of
    # CPU emulation at real widths, so token count is pure wall time
    stage $M serve python tools/cpurun.py -n 8 mxmoe.serving.generate \
        --model $M --artifact $OUT/$M/ckpt-w5-packed --mesh 8 \
        --gate-trace $G --prompt "1 2 3 4" --max-new 4 --chunk 4 --slots 8 \
        --max-len 256 --decode-attn xla || return 1
}

RC=0
case "${1:-all}" in
    qwen2_moe)     run_model qwen2_moe 24 || RC=1 ;;
    ds2)           run_model ds2 27 || RC=1 ;;
    qwen2_moe_57b) run_model qwen2_moe_57b 4 lite || RC=1 ;;
    mixtral)       run_model mixtral 4 lite || RC=1 ;;
    all)
        run_model qwen2_moe 24 || RC=1
        run_model ds2 27 || RC=1
        run_model qwen2_moe_57b 4 lite || RC=1
        run_model mixtral 4 lite || RC=1
        ;;
esac
echo "== runbook done; times:"
cat $TSV
if [ -n "$FAILED_STAGES" ]; then
    echo "== FAILED stages:$FAILED_STAGES"
    exit 1
fi
exit $RC
