"""The trace reader (``utils/trace.py``, the counterpart of the JAX
package's ``utils/xplane.py``) on a hand-written Chrome trace with known
windows, kernels, copies and gaps, and on a real ``torch.profiler`` trace
of a tiny training step on the CPU (the schema the reader parses: step
windows and host ops; a CPU trace has no device events).
"""
import json

import numpy as np
import pytest
import torch

from pb_sed_tpu_torch.train.trainer import Trainer
from pb_sed_tpu_torch.utils import trace
from pb_sed_tpu_torch.utils.profiling import step_times_ms
from tests.test_torch_mesh import WEAK, _batch, _model

torch.set_num_threads(2)


def _x(name, cat, ts, dur, **extra):
    return dict(name=name, cat=cat, ph='X', ts=ts, dur=dur, pid=0, tid=0,
                **extra)


EVENTS = [
    # step 1: [0, 1000) µs; step 2: [2000, 3200) µs
    _x('train_step_1', 'user_annotation', 0., 1000.),
    _x('train_step_2', 'user_annotation', 2000., 1200.),
    _x('aten::conv2d', 'cpu_op', 10., 300.),
    _x('cudaLaunchKernel', 'cuda_runtime', 20., 5.),
    _x('void conv_kernel<64, 3>(Params)', 'kernel', 100., 200.),
    _x('void at::native::vectorized_elementwise_kernel<4, float>(int)',
       'kernel', 350., 100.),
    _x('void conv_kernel<64, 1>(Params)', 'kernel', 800., 150.),
    _x('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 960., 20.),
    # step 2: two kernels that overlap (two streams), then the host waits
    _x('aten::copy_', 'cpu_op', 2000., 90.),
    _x('void conv_kernel<64, 3>(Params)', 'kernel', 2100., 300.),
    _x('void gru_cluster_fwd<256>(Args)', 'kernel', 2200., 300.),
    _x('aten::item', 'cpu_op', 2550., 600.),
    _x('cudaStreamSynchronize', 'cuda_runtime', 2560., 580.),
    # a metadata event and a flow event the reader skips
    {'name': 'process_name', 'ph': 'M', 'pid': 0},
    {'name': 'ac2g', 'ph': 'f', 'cat': 'ac2g', 'ts': 20., 'id': 1},
]


@pytest.fixture
def trace_path(tmp_path):
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': EVENTS}))
    return path


def test_device_step_times_are_the_union_of_device_intervals(trace_path):
    got = trace.device_step_times_ms(trace_path)
    assert got == pytest.approx({1: .47, 2: .4})
    # the sum of the durations counts the overlap of step 2 twice
    assert step_times_ms(trace_path)[2] == pytest.approx((1.2, .6))


def test_module_spans_and_busy_times(trace_path):
    assert trace.module_spans_by_name(trace_path) == pytest.approx(
        {'train_step': [1., 1.2]})
    assert trace.module_spans_by_name(trace_path, collapse=False) == \
        pytest.approx({'train_step_1': [1.], 'train_step_2': [1.2]})
    assert trace.module_busy_times_ms(trace_path) == pytest.approx(
        [(1., .47), (1.2, .4)])


@pytest.mark.parametrize('collapse', [True, False])
def test_op_breakdown_collapses_templates(trace_path, collapse):
    got = trace.op_breakdown_ms(trace_path, collapse=collapse)
    if collapse:
        assert got == {'conv_kernel': (.65, 3), 'gru_cluster_fwd': (.3, 1),
                       'at::native::vectorized_elementwise_kernel': (.1, 1),
                       'Memcpy HtoD': (.02, 1)}
        assert list(trace.op_breakdown_ms(trace_path, top=2)) == [
            'conv_kernel', 'gru_cluster_fwd']
    else:
        assert got['void conv_kernel<64, 3>(Params)'] == (.5, 2)
        assert got['void conv_kernel<64, 1>(Params)'] == (.15, 1)


def test_stall_gaps_name_the_host_op_behind_each(trace_path):
    got = trace.stall_gaps_ms(trace_path, min_gap_ms=.05)
    assert got == {
        'span_ms': 1.2, 'busy_ms': .4, 'gap_ms': .8, 'n_gaps': 2,
        'gaps': [(.7, .5, 'cudaStreamSynchronize'),
                 (.1, 0., 'aten::copy_')],
    }
    assert trace.stall_gaps_ms(trace_path, min_gap_ms=.2)['n_gaps'] == 1
    # a gap with no op behind it is the window's own: Python between ops
    first = trace.stall_gaps_ms(trace_path, min_gap_ms=.05,
                                prefix='train_step_1')
    assert (.35, .45, 'train_step_1') in first['gaps']
    assert trace.stall_gaps_ms(trace_path, prefix='validate_') == {}


def test_duty_cycle_summary(trace_path):
    got = trace.duty_cycle_summary(trace_path)
    assert got == {'span_ms': 1.1, 'busy_ms': .435,
                   'duty_cycle': round(.435 / 1.1, 4), 'n_windows': 2}
    assert trace.duty_cycle_summary(trace_path, min_span_ms=1.1) == {
        'span_ms': 1.2, 'busy_ms': .4, 'duty_cycle': round(.4 / 1.2, 4),
        'n_windows': 1}


def test_collapse_name():
    assert trace.collapse_name('void k<64, 3>(Params)') == 'k'
    assert trace.collapse_name('Memcpy DtoD (Device -> Device)') == \
        'Memcpy DtoD'
    assert trace.collapse_name('ampere_sgemm_128x64_nn') == \
        'ampere_sgemm_128x64_nn'


def test_a_real_cpu_trace_of_a_training_step(tmp_path, capsys):
    """The trainer's profiled steps on the CPU: the reader finds their
    windows and host ops; a CPU trace holds no device work."""
    trainer = Trainer(_model(WEAK), storage_dir=tmp_path, profile_at=1,
                      profile_num_steps=2, stop_trigger=(2, 'iteration'))
    trainer.train([_batch(1, n=2), _batch(2, n=2)])
    out = capsys.readouterr().out
    assert out.count('Profiled step') == 2
    (path,) = (tmp_path / 'profile').glob('trace_*.json')
    events = trace.trace_events(path)
    assert trace.device_step_times_ms(events) == {1: 0., 2: 0.}
    spans = trace.module_spans_by_name(events, prefix='train_step_')
    assert len(spans['train_step']) == 2 and min(spans['train_step']) > 0
    assert trace.op_breakdown_ms(events) == {}
    stalls = trace.stall_gaps_ms(events, min_gap_ms=0.)
    assert stalls['busy_ms'] == 0. and stalls['n_gaps'] == 1
    assert np.isclose(stalls['gap_ms'], stalls['span_ms'], atol=1e-3)
    assert isinstance(stalls['gaps'][0][2], str)   # a host event spans it
    assert trace.duty_cycle_summary(events) == {}
