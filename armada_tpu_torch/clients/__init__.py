"""The port's clients: armadactl (`cli.py`), the asyncio client
(`aio.py`), the load tester (`load_tester.py`) and the broadside load
bench (`broadside.py`), copies of the JAX package's `clients/`."""
