"""Experiment harness (sacred-surface parity).

Capability parity with the sacred usage in the reference (SURVEY.md
§2.3h): ``Experiment`` objects with ``@ex.config`` config functions
(derived values respecting CLI overrides), ``@ex.automain``, CLI
``with key=value ...`` overrides, ``print_config``, a
``FileStorageObserver`` persisting ``<storage_dir>/1/config.json`` (the
exact path later stages reload configs from —
``experiments/weak_label_crnn/tuning.py:39``), and programmatic chaining
via ``ex.run(config_updates={...})``.

Config functions receive a :class:`ConfigDict` pre-seeded with the CLI /
programmatic overrides and use ``cfg.setdefault``-style assignment, so
derived values (e.g. iteration counts scaled by an overridden batch size)
are computed from the overridden values like sacred's dependency
re-execution achieves.

Under ``torchrun`` (several ranks, one card each) the command line forms
the process group first (``parallel.mesh.initialize_distributed``, NCCL
on the card, gloo with ``device=cpu``); every ``run`` then takes rank 0's
config, whose timestamped storage directory every rank uses, and rank 0
alone writes ``config.json`` while the others wait for it.
"""
import ast
import sys
from pathlib import Path

from pb_sed_tpu_torch.parallel.mesh import (barrier, broadcast_object,
                                            initialize_distributed,
                                            is_main_process)
from pb_sed_tpu_torch.utils.config import config_to_json
from pb_sed_tpu_torch.utils.misc import dump_json
from pb_sed_tpu_torch.utils.nested import deflatten


class ConfigDict(dict):
    """Dict where plain assignment only fills missing keys (overrides win)
    and nested dicts merge recursively."""

    def __setitem__(self, key, value):
        if key in self:
            existing = self[key]
            if isinstance(existing, dict) and isinstance(value, dict):
                _merge_defaults(existing, value)
            return
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = _to_config_dict(value)
        super().__setitem__(key, value)

    def force(self, key, value):
        super().__setitem__(key, value)


def _to_config_dict(d):
    out = ConfigDict()
    for key, value in d.items():
        out.force(key, _to_config_dict(value) if isinstance(value, dict)
                  else value)
    return out


def _merge_defaults(existing, defaults):
    for key, value in defaults.items():
        if key in existing:
            if isinstance(existing[key], dict) and isinstance(value, dict):
                _merge_defaults(existing[key], value)
        else:
            if isinstance(existing, ConfigDict):
                existing.force(
                    key, _to_config_dict(value)
                    if isinstance(value, dict) else value)
            else:
                existing[key] = value


def parse_cli_overrides(argv):
    """Parse ``with a.b=c x=1`` into a nested updates dict."""
    if 'with' in argv:
        argv = argv[argv.index('with') + 1:]
    flat = {}
    for token in argv:
        if '=' not in token:
            continue
        key, _, raw = token.partition('=')
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        flat[key] = value
    return deflatten(flat)


def print_config(config, indent=0):
    if indent == 0:
        print('Configuration:')
    for key in sorted(config.keys()):
        value = config[key]
        if isinstance(value, dict):
            print(' ' * (indent + 2) + f'{key}:')
            print_config(value, indent + 2)
        else:
            print(' ' * (indent + 2) + f'{key} = {value!r}')


class FileStorageObserver:
    """Writes ``<basedir>/1/config.json`` (load-bearing path)."""

    def __init__(self, basedir):
        self.basedir = Path(basedir)

    @classmethod
    def create(cls, basedir):
        return cls(basedir)

    def save_config(self, config):
        run_dir = self.basedir / '1'
        run_dir.mkdir(parents=True, exist_ok=True)
        dump_json(config_to_json(dict(config)), run_dir / 'config.json')


class Experiment:
    def __init__(self, name):
        self.name = name
        self.config_fns = []
        self.main_fn = None
        self.observers = []

    def config(self, fn):
        self.config_fns.append(fn)
        return fn

    def main(self, fn):
        self.main_fn = fn
        return fn

    def automain(self, fn):
        self.main_fn = fn
        if fn.__module__ == '__main__':
            self.run_commandline()
        return fn

    def run_commandline(self, argv=None):
        argv = sys.argv[1:] if argv is None else argv
        updates = parse_cli_overrides(argv)
        # under torchrun: the process group, before the config is agreed
        initialize_distributed(device=updates.get('device'))
        return self.run(config_updates=updates)

    def build_config(self, config_updates=None):
        cfg = _to_config_dict(config_updates or {})
        for fn in self.config_fns:
            fn(cfg)
        return cfg

    def run(self, config_updates=None):
        self.observers = []
        cfg = self.build_config(config_updates)  # may append observers
        # every rank runs rank 0's config (its timestamps, its paths)
        cfg, self.observers = broadcast_object((cfg, self.observers))
        # the `device` config (None: the card; 'cpu' or another torch
        # device string) is read by the experiment's main function
        assert self.main_fn is not None, 'no main function registered'
        import inspect
        sig = inspect.signature(self.main_fn)
        kwargs = {}
        for name, param in sig.parameters.items():
            if name == '_run':
                kwargs['_run'] = cfg
            elif name == '_config':
                kwargs['_config'] = cfg
            elif name in cfg:
                kwargs[name] = cfg[name]
            elif param.default is inspect.Parameter.empty:
                raise KeyError(
                    f'config key {name!r} required by main() is missing')
        # save configs for any observers registered during config fns
        if is_main_process():
            for observer in self.observers:
                observer.save_config(cfg)
        barrier()
        return self.main_fn(**kwargs)
