#!/usr/bin/env bash
# Runs `tools/torch_synthfaces_hard.py all` under a time limit and copies every
# small result of its work directory to OUT on every exit, a run cut by the
# limit included: DIR/*.json and DIR/*.log (the stages' records, each rank's,
# the classifier's and each scorer's log), both curve files and every scorer's
# part files, the scalars, the rank dumps, a listing of the snapshot files and
# the cards' name and power limit. Pass `--docs OUT/docs` to the tool to have
# the report's folder among them.
#
#   tools/torch_synthfaces_hard_call.sh WORK OUT LIMIT_SECONDS [tool arguments ...]
#
# The tool's output goes to OUT/tool.log, ending with its exit code. If the
# tool fails inside its limit (a scorer that failed, say), `report` runs once
# more on what the work directory holds, within REPORT_LIMIT seconds (240).
set -u
work=$1
out=$2
limit=$3
shift 3
repo=$(cd "$(dirname "$0")/.." && pwd)
mkdir -p "$out/work"

copy() {
  local run="$work/run/outputs/synthfaces_hard" d
  cp "$work"/*.json "$work"/*.log "$out/work/" 2>/dev/null
  cp "$run"/fid_curve_*.json "$out/work/" 2>/dev/null
  for d in "$work"/score/*/; do
    [ -d "$d" ] || continue
    mkdir -p "$out/work/score/$(basename "$d")"
    cp "$d"fid_curve_*.json "$out/work/score/$(basename "$d")/" 2>/dev/null
  done
  cp "$work/run/logs/synthfaces_hard/scalars.jsonl" "$out/work/" 2>/dev/null
  [ -d "$work/dumps" ] && cp -r "$work/dumps" "$out/work/" 2>/dev/null
  ls -l "$run/checkpoints" > "$out/work/checkpoints.txt" 2>/dev/null
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$out/cards.txt" 2>&1
  return 0
}
trap copy EXIT

cd "$repo" || exit 2
timeout -k 30 "$limit" python3 tools/torch_synthfaces_hard.py all --work "$work" "$@" \
  > "$out/tool.log" 2>&1
rc=$?
echo "exit $rc" >> "$out/tool.log"
if [ "$rc" -ne 0 ] && [ "$rc" -ne 124 ] && [ "$rc" -ne 137 ]; then
  copy
  timeout -k 10 "${REPORT_LIMIT:-240}" python3 tools/torch_synthfaces_hard.py report \
    --work "$work" "$@" >> "$out/tool.log" 2>&1
  echo "report exit $?" >> "$out/tool.log"
fi
exit "$rc"
