#!/bin/bash
# Runs chip_smoke.py from DIR (default: the repo) in a session of its own and
# lists the machine's processes before it, every 20 s while it runs, and 0, 3
# and 10 s after it ends, into OUT (default: DIR/artifacts/smoke_procs).
# Prints chip_smoke.py's exit code and wall seconds, its last lines, and each
# process found after it that was not there before it (none is the pass).
# Usage: bash scripts/chip_smoke_procs.sh [DIR] [OUT]
dir=$(cd "${1:-$(dirname "$0")/..}" && pwd) || exit 1
mkdir -p "${2:-$dir/artifacts/smoke_procs}" || exit 1
out=$(cd "${2:-$dir/artifacts/smoke_procs}" && pwd)
PS="ps -eo pid,ppid,pgid,sid,etimes,stat,args"
$PS > "$out/ps_before.txt"
t0=$(date +%s)
(cd "$dir" && exec setsid python3 chip_smoke.py > "$out/smoke.log" 2> "$out/smoke.err") &
pid=$!
(while kill -0 $pid 2> /dev/null; do echo "== +$(( $(date +%s) - t0 )) s"; $PS --forest; sleep 20; done) \
  > "$out/ps_during.txt" 2>&1 &
sampler=$!
wait $pid
rc=$?
pkill -P $sampler 2> /dev/null   # its sleep; the loop then ends, chip_smoke.py being gone
wait $sampler 2> /dev/null
echo "chip_smoke.py exit $rc after $(( $(date +%s) - t0 )) s"
tail -n 4 "$out/smoke.log" | cut -c1-300
: > "$out/ps_after.txt"
for t in 0 3 7; do
  sleep $t
  echo "== after +$t s" >> "$out/ps_after.txt"
  $PS >> "$out/ps_after.txt"
done
# pids in the last listing that the first did not hold, other than this script and ps
awk -v self=$$ 'NR == FNR { if (FNR > 1) seen[$1] = 1; next }
  /^== after/ { n++; next }
  { rows[n] = rows[n] $0 "\n" }
  END { split(rows[n], lines, "\n");
        for (i in lines) { split(lines[i], f, " ");
          if (f[1] ~ /^[0-9]+$/ && !(f[1] in seen) && f[1] != self && f[2] != self) print "left: " lines[i] } }' \
  "$out/ps_before.txt" "$out/ps_after.txt" | tee "$out/left.txt"
[ -s "$out/left.txt" ] || echo "no process left after chip_smoke.py"
exit $rc
