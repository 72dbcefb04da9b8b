from .runner import TestSpec, TestSuiteRunner, run_spec_file

__all__ = ["TestSpec", "TestSuiteRunner", "run_spec_file"]
