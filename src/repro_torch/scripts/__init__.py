# repro_torch.scripts — the port's twins of scripts/smoke_core.py and
# scripts/obs_report.py: `python -m repro_torch.scripts.<name>`.
