"""The contract-checker CLI body (``python -m repro_torch.check``).

Records every registered contract (``--device cuda``, the default: on
the card, under ``set_sync_debug_mode("error")``; ``--device cpu``: on
fake ``cuda`` tensors, nothing runs), applies its rules, and prints a
per-contract pass/fail table -- to stdout always, appended to
``$GITHUB_STEP_SUMMARY`` when set.  Exit status is nonzero if ANY
contract fails, including contracts whose surface fails to record: a
host read smuggled into a hot path raises inside the recording, and that
is as much a violation as a banned collective.  No contract is ever
skipped: a rule part only the card can check shows as "n/a on cpu".
"""
from __future__ import annotations

import argparse
import os
import sys
import traceback

__all__ = ["main", "run_contracts"]


def run_contracts(only: str | None = None, verbose: bool = False,
                  device: str = "cuda"):
    """Record + check every contract; returns (results, n_fail).

    ``results`` is a list of (contract, violations, error, unchecked,
    surface): ``error`` is the formatted exception of a surface that
    failed to record (None if it recorded, and then ``surface`` is the
    recording), ``violations`` the rule findings (empty on pass) and
    ``unchecked`` what only the card can check (empty on the card)."""
    from repro_torch._device import resolve_device
    from repro_torch.check.contracts import registry
    from repro_torch.check.rules import run_rules
    dev = resolve_device(device).type
    results = []
    for name, con in registry().items():
        if only and only not in name:
            continue
        violations, error, unchecked, surface = [], None, [], None
        try:
            surface = con.build(dev)
            violations = run_rules(con.rules, surface)
            unchecked = [u for r in con.rules
                         if (u := r.unchecked(surface)) is not None]
        except Exception:
            error = traceback.format_exc()
        results.append((con, violations, error, unchecked, surface))
        if verbose:
            status = "FAIL" if (violations or error) else "pass"
            print(f"  {name}: {status}", flush=True)
    n_fail = sum(1 for _, v, e, _, _ in results if v or e)
    return results, n_fail


def _table(results) -> str:
    rows = ["| contract | surface | rules | status |",
            "| --- | --- | --- | --- |"]
    for con, violations, error, unchecked, _ in results:
        rules = "; ".join(r.describe() for r in con.rules)
        if error:
            status = "**FAIL** (trace error)"
        elif violations:
            status = f"**FAIL** ({len(violations)})"
        else:
            status = "pass"
        if unchecked and not error:
            status += " (" + "; ".join(unchecked) + ")"
        rows.append(f"| {con.name} | `{con.surface}` | {rules} | {status} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="record every declared performance contract of the "
                    "port and enforce its rules")
    ap.add_argument("--gate", action="store_true",
                    help="CI alias: identical behaviour, kept so the gate "
                         "invocation reads like the other bench gates")
    ap.add_argument("--only", metavar="SUBSTR",
                    help="check only contracts whose name contains SUBSTR")
    ap.add_argument("--list", action="store_true",
                    help="list contracts and rules without recording")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print per-contract progress while recording")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: run on the card) or cpu (fake "
                         "cuda tensors, nothing runs)")
    args = ap.parse_args(argv)

    from repro_torch.check.contracts import registry
    if args.list:
        for name, con in registry().items():
            ref = f" (reference: {con.ref_name})" if con.ref_name != name \
                else ""
            print(f"{name}{ref}  ->  {con.surface}")
            for r in con.rules:
                print(f"    - {r.describe()}")
        return 0

    results, n_fail = run_contracts(only=args.only, verbose=args.verbose,
                                    device=args.device)
    if not results:
        print(f"no contracts match --only {args.only!r}")
        return 1

    for con, violations, error, _, _ in results:
        if error:
            print(f"\n--- {con.name} ({con.surface}): TRACE ERROR ---")
            print(error.rstrip())
        for v in violations:
            print(f"\n--- {con.name} ({con.surface}) ---\n  {v}")

    table = _table(results)
    verdict = (f"{len(results)} contracts, {n_fail} failed" if n_fail
               else f"all {len(results)} contracts hold")
    print(f"\n{table}\n\ncheck-gate ({args.device}): {verdict}")
    summary = os.environ.get("GITHUB_STEP_SUMMARY")
    if summary:
        with open(summary, "a") as f:
            f.write(f"### Contract checks ({args.device}) -- {verdict}\n\n"
                    f"{table}\n")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
