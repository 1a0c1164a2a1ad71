"""The yardstick of the rooflines: the card's peaks and the kernels'
bounds (`bounds.py`), the launch recorder (`record.py`), the tool that
freezes a cell's work (`freeze.py`) and each cell's frozen work
(`<cell>.json`)."""
