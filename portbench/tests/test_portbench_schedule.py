"""The open loop's schedule and the end-to-end arithmetic, with a fake decoder and clock."""

import numpy as np
import pytest

from portbench import schedule


class FakeClock:
    def __init__(self):
        self.t = 100.0
        self.reads = 0

    def __call__(self):  # each read of the clock takes a microsecond
        self.t += 1e-6
        self.reads += 1
        return self.t


def drive(clock, service, period=0.03125, n=8):
    """The online driver's loop against a decoder that takes ``service[i]`` s."""
    due = schedule.due_times(clock() + 0.02, period, n)
    handed, arrived = [], []
    for i in range(n):
        handed.append(schedule.wait_until(due[i], clock))
        clock.t += service[i]
        arrived.append(clock())
    return due, np.asarray(handed), np.asarray(arrived)


def test_packets_fall_due_on_the_amplifiers_period():
    assert schedule.packet_count(40, 32 / 1024) == 1280
    assert schedule.packet_count(40, 64 / 2048) == 1280
    assert schedule.packet_count(10, 0.03125) == 320
    np.testing.assert_allclose(np.diff(schedule.due_times(5.0, 0.03125, 4)), 0.03125)


def test_the_generator_waits_for_due_times_and_never_for_the_decoder():
    clock = FakeClock()
    service = [0.001] * 8
    service[2] = 0.1  # a stall: three more packets fall due meanwhile
    due, handed, arrived = drive(clock, service)
    late = handed - due
    assert late[:3].max() < 2e-5
    assert late[3] > 0.05 and late[4] > 0.02          # handed at once when overdue
    lat = schedule.latencies(due, arrived)
    # latency from the due time counts the wait behind the stall
    assert lat[2] == pytest.approx(0.1, abs=1e-4)
    assert lat[3] == pytest.approx(0.1 + 0.001 - 0.03125, abs=1e-4)
    assert lat[6] == pytest.approx(0.001, abs=1e-4)


def test_the_wait_spins_to_the_due_time():
    clock = FakeClock()
    due = clock() + 0.01
    done = schedule.wait_until(due, clock)
    assert clock.reads == pytest.approx(10_001, abs=2)   # read the clock all the way
    assert due <= done < due + 2e-6
    assert schedule.wait_until(due - 1.0, clock) > due    # an overdue packet goes at once


def test_percentiles_and_rate_over_a_window_with_a_stall():
    lat = np.full(1000, 0.0005)
    lat[500:520] = 0.050  # one stall delays 20 packets
    assert schedule.percentile_ms(lat, 50) == pytest.approx(0.5)
    assert schedule.percentile_ms(lat, 99) == pytest.approx(50.0)
    assert schedule.percentile_ms(lat[:990], 99) == pytest.approx(50.0)
    lat[510:520] = 0.0005
    assert schedule.percentile_ms(lat, 99) == pytest.approx(0.5 + 0.01 * 49.5)
    # the replay's rate counts every session finished over the whole window
    assert schedule.rate(1000 * 1800, 40.0) == 45000.0


def test_latencies_of_packets_that_never_came_are_not_invented():
    due = schedule.due_times(0.0, 1.0, 5)
    assert len(schedule.latencies(due, [0.5, 1.5, 2.5])) == 3
